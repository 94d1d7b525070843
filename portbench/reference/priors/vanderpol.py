"""The Van der Pol oscillator (d = 2):
``f₁ = τa(x₁ − x₁³/3 − x₂)``, ``f₂ = τx₁/a``."""


def drift(x, kw, xp):
    a, tau = kw["a"], kw["tau"]
    x1, x2 = x[..., 0], x[..., 1]
    return xp.stack([tau * a * (x1 - x1 ** 3 / 3.0 - x2), tau * x1 / a], -1)


def jacobian(x, kw):
    import torch

    a, tau = kw["a"], kw["tau"]
    x1 = x[..., 0]
    row1 = torch.stack([tau * a * (1.0 - x1 * x1), torch.full_like(x1, -tau * a)], -1)
    row2 = torch.stack([torch.full_like(x1, tau / a), torch.zeros_like(x1)], -1)
    return torch.stack([row1, row2], -2)
