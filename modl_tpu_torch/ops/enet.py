"""Elastic-net ball geometry in PyTorch.

Counterpart of ``modl_tpu/ops/enet.py`` (itself the reference's
``enet.pyx:38-168``):

- ``enet_norm``       sum |v| (l1r + (1 - l1r)|v|)
- ``enet_scale``      closed-form scaling onto the ball
- ``enet_projection`` exact projection: a descending sort plus
  cumulative sums find the support size ``rho`` and the threshold of
  enet.pyx:113-121, batched over rows (``enet_projection_batch``)
- ``enet_projection_bisect`` the same projection without a sort:
  bisection on the shrinkage threshold.

``l1_ratio`` is a Python float that selects the code path; ``radius``
may be a tensor (per row for the batched form).
"""
import torch

__all__ = ["enet_norm", "enet_scale", "enet_projection",
           "enet_projection_batch", "enet_projection_bisect"]


def enet_norm(v, l1_ratio, axis=-1):
    """Elastic-net norm ``sum_i |v_i| (l1_ratio + (1 - l1_ratio) |v_i|)``."""
    a = torch.abs(v)
    return torch.sum(a * (l1_ratio + (1.0 - l1_ratio) * a), dim=axis)


def enet_scale(v, l1_ratio, radius=1.0, axis=-1):
    """Scale ``v`` so that its elastic-net norm equals ``radius``.

    Finds S >= 0 with ``l1_ratio S ||v||_1 + (1 - l1_ratio) S^2 ||v||_2^2
    = radius``; a zero vector maps to itself.
    """
    l1 = torch.sum(torch.abs(v), dim=axis, keepdim=True) * l1_ratio
    l2 = torch.sum(v * v, dim=axis, keepdim=True) * (1.0 - l1_ratio)
    safe_l2 = torch.where(l2 != 0, l2, torch.ones_like(l2))
    safe_l1 = torch.where(l1 != 0, l1, torch.ones_like(l1))
    s_quad = (-l1 + torch.sqrt(l1 * l1 + 4.0 * radius * safe_l2)) \
        / (2.0 * safe_l2)
    s_lin = radius / safe_l1
    S = torch.where(l2 != 0, s_quad,
                    torch.where(l1 != 0, s_lin, torch.zeros_like(l1)))
    return v * S


def enet_projection_batch(V, radii, l1_ratio):
    """Row-wise projection of ``V`` (..., m) on the elastic-net balls of
    per-row ``radii`` (...,), exact (sort-based)."""
    dtype = V.dtype
    radius = torch.as_tensor(radii, dtype=dtype,
                             device=V.device)[..., None]
    zero = torch.zeros((), dtype=dtype, device=V.device)

    if l1_ratio == 0.0:
        norm2 = torch.sum(V * V, dim=-1, keepdim=True)
        tiny = torch.finfo(dtype).tiny
        scale = torch.where(norm2 <= radius, torch.ones_like(norm2),
                            torch.sqrt(norm2 / torch.clamp(radius, min=tiny)))
        return torch.where(radius > 0, V / scale, zero)

    m = V.shape[-1]
    gamma = 2.0 / l1_ratio - 2.0
    r = radius / l1_ratio
    b = torch.abs(V)
    norm = torch.sum(b * (1.0 + gamma / 2.0 * b), dim=-1, keepdim=True)

    # support size: the pivot-inclusion test of enet.pyx:100-101 at every
    # prefix of the magnitudes sorted in descending order
    bs = torch.flip(torch.sort(b, dim=-1).values, dims=(-1,))
    terms = bs * (1.0 + gamma / 2.0 * bs)
    s_cum = torch.cumsum(terms, dim=-1)
    j = torch.arange(1, m + 1, dtype=dtype, device=V.device)
    cond = (s_cum - j * (1.0 + gamma / 2.0 * bs) * bs
            < r * (1.0 + gamma * bs) ** 2)
    rho = torch.sum(cond.to(dtype), dim=-1, keepdim=True)
    s = torch.sum(torch.where(cond, terms, zero), dim=-1, keepdim=True)

    if gamma != 0.0:            # true elastic-net ball, enet.pyx:113-117
        a = gamma ** 2 * r + gamma * rho * 0.5
        d = 2.0 * r * gamma + rho
        c = r - s
        disc = torch.clamp(d * d - 4.0 * a * c, min=0.0)
        lam = (-d + torch.sqrt(disc)) / (2.0 * a)
    else:                       # pure l1 ball, enet.pyx:119
        lam = (s - r) / torch.clamp(rho, min=1.0)

    shrunk = torch.sign(V) * torch.clamp(b - lam, min=0.0) \
        / (1.0 + lam * gamma)
    out = torch.where(norm <= r, V, shrunk)
    return torch.where(radius > 0, out, zero)


def enet_projection(v, radius, l1_ratio):
    """Projection of one vector ``v`` (m,) on the elastic-net ball."""
    return enet_projection_batch(v[None, :], torch.as_tensor(
        radius, dtype=v.dtype, device=v.device).reshape(1), l1_ratio)[0]


def enet_projection_bisect(v, radius, l1_ratio, n_iter=40):
    """Projection of ``v`` (m,) on the elastic-net ball by bisection on
    the shrinkage threshold (``modl_tpu.ops.enet.enet_projection_bisect``).

    The KKT threshold ``lam`` solves the monotone scalar equation
    ``norm(w(lam)) = radius`` with ``w(lam) = sign(v) max(|v| - lam, 0)
    / (1 + lam gamma)``; ``n_iter`` halvings of ``[0, max |v|]`` reach
    ~2^-n_iter of it, with no sort. ``l1_ratio == 0`` takes the exact
    l2 scaling."""
    dtype = v.dtype
    radius = torch.as_tensor(radius, dtype=dtype, device=v.device)
    if l1_ratio == 0.0:
        return enet_projection(v, radius, l1_ratio)

    gamma = 2.0 / l1_ratio - 2.0
    r = radius / l1_ratio
    b = torch.abs(v)
    norm = torch.sum(b * (1.0 + gamma / 2.0 * b))

    def scaled_norm(lam):
        w = torch.clamp(b - lam, min=0.0) / (1.0 + lam * gamma)
        return torch.sum(w * (1.0 + gamma / 2.0 * w))

    lo = torch.zeros((), dtype=dtype, device=v.device)
    hi = torch.max(b)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_big = scaled_norm(mid) > r
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)
    shrunk = torch.sign(v) * torch.clamp(b - lam, min=0.0) \
        / (1.0 + lam * gamma)
    out = torch.where(norm <= r, v, shrunk)
    return torch.where(radius > 0, out, torch.zeros_like(v))
