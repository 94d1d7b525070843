"""The two-layer MLP drift ``f(x) = relu(x w₁ + b₁) w₂ + b₂``, ``1 → H → 1``
(d = 1): ``kw`` holds ``w1 [1, H]``, ``b1 [H]``, ``w2 [H, 1]`` and
``b2 [1]``, as arrays of ``xp`` or as tensors that may require grad."""


def drift(x, kw, xp):
    pre = x @ kw["w1"] + kw["b1"]
    hidden = xp.maximum(pre, 0.0) if xp.__name__ == "numpy" else xp.relu(pre)
    return hidden @ kw["w2"] + kw["b2"]


def jacobian(x, kw):
    """``∂f/∂x = Σⱼ w₁ⱼ w₂ⱼ 1[x w₁ⱼ + b₁ⱼ > 0]`` ``[..., 1, 1]``; the step
    of the relu at 0 counts as 0, and carries no gradient."""
    active = (x @ kw["w1"] + kw["b1"] > 0).to(x.dtype)
    return (active * (kw["w1"][0] * kw["w2"][:, 0])).sum(-1)[..., None, None]
