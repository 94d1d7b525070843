"""Drifts of the prior SDEs, one module per ``prior_sde`` name of a
configuration file.  Each module defines ``drift(x, kw, xp)`` for
``x [..., d]`` with ``xp`` the array module (``numpy`` or ``torch``), and
``jacobian(x, kw)`` (torch) ``[..., d, d]``; ``kw`` is the configuration's
``prior_sde_kwargs``."""
