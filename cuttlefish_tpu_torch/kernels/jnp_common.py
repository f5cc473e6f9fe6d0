"""Torch ops of the JAX package's ``jnp``-path helpers, for the encoders
that the JAX package runs as XLA programs with no TPU kernel (the ASTC HDR
profile, ``kernels/astc_hdr.py``, and PVRTC, ``kernels/pvrtc.py``).

``select_at_max``, ``principal_axis`` and ``ls_solve`` are
``cuttlefish_tpu/kernels/bc.py:select_at_max``, ``_principal_axis`` and
``_ls_solve``.  Layout follows the JAX functions (``[N, T, C]`` texels,
``[N, C]`` per block).  Their sums are written out in the order XLA's CPU
backend takes under ``--xla_cpu_max_isa=AVX`` with its algebraic
simplifier off: the small dots (covariance, ``"ni,nic->nc"``, ``"nc,ncd"``
and the norms) as left folds (``fold``), the reductions over the texels
as left folds up to 32 texels and, above that, as XLA's tree-reduction
rewrite computes them (``tsum``).  Every operation is elementwise, so the
CPU and the card compute them alike, and no matrix unit or TF32 setting
reaches them; a division by a number that is not a power of two goes
through ``div``, as the card would otherwise multiply by its reciprocal.
"""

from __future__ import annotations

import torch


def fold(terms):
    """Left fold ``((t0 + t1) + t2) + ...`` of a list of tensors."""
    acc = terms[0]
    for x in terms[1:]:
        acc = acc + x
    return acc


def tsum(terms):
    """Sum of a reduction over ``len(terms)`` texels as XLA's CPU backend
    computes ``x.sum(axis)``: a left fold up to 32 terms; above, the tree
    reduction rewrite's windows of 32 (SAME padding with zeros), each a
    left fold, then the windows' left fold."""
    n = len(terms)
    if n <= 32:
        return fold(terms)
    windows = -(-n // 32)
    pad = windows * 32 - n
    lo = pad // 2
    parts = []
    for k in range(windows):
        start = max(0, k * 32 - lo)
        stop = min(n, (k + 1) * 32 - lo)
        parts.append(fold(terms[start:stop]))
    return fold(parts)


def div(x, c: float):
    """``x / c`` for a Python number ``c`` as an IEEE division on every
    device: on a CUDA tensor PyTorch computes ``x / scalar`` as ``x * (1 /
    scalar)``, which differs from the division by an ulp for some ``x``
    unless ``c`` is a power of two."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sqrt_f32(x):
    """Correctly rounded float32 square root (sqrtf), through float64:
    PyTorch's CPU float32 sqrt can be one ulp off."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def norm(v):
    """``jnp.linalg.norm(v, axis=-1)`` of [N, C]: sqrt of the left fold of
    the squares."""
    return sqrt_f32(fold([v[:, c] * v[:, c] for c in range(v.shape[-1])]))


def select_at_max(values: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """data row at the FIRST maximal value: values [N,T], data [N,T,C] ->
    [N,C] (``bc.py:select_at_max``)."""
    t = values.shape[1]
    is_max = values == values.max(1, keepdim=True).values
    pos = torch.arange(t, device=values.device).expand_as(values)
    first = torch.where(is_max, pos, t).min(1).values
    return data[torch.arange(data.shape[0], device=data.device), first]


def principal_axis(centered: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Dominant eigenvector of each block's covariance (``bc.py:
    _principal_axis``): centered [N,T,C] -> [N,C]; seeded from the texel
    of largest residual, degenerate iterations keep the last direction."""
    n, t, c = centered.shape
    cov = [
        [fold([centered[:, i, a] * centered[:, i, b] for i in range(t)]) for b in range(c)]
        for a in range(c)
    ]
    norms = fold([centered[..., a] * centered[..., a] for a in range(c)])
    start = select_at_max(norms, centered)
    n0 = norm(start)[:, None]
    v = torch.where(n0 > 1e-10, start / (n0 + 1e-20), torch.ones_like(start))
    for _ in range(iters):
        nv = torch.stack([fold([cov[a][b] * v[:, b] for b in range(c)]) for a in range(c)], -1)
        nn = norm(nv)[:, None]
        v = torch.where(nn > 1e-10, nv / (nn + 1e-20), v)
    return v


def ls_solve(colors: torch.Tensor, w: torch.Tensor):
    """Least-squares endpoints for fixed weights (``bc.py:_ls_solve`` with
    every texel valid): colors [N,T,C], w [N,T] in [0,1]; minimises
    sum ||c - (w e0 + (1-w) e1)||^2.  Returns (e0, e1) [N,C], the mean on
    singular systems."""
    n, t, c = colors.shape
    u = 1.0 - w
    a11 = tsum([w[:, i] * w[:, i] for i in range(t)])
    a12 = tsum([w[:, i] * u[:, i] for i in range(t)])
    a22 = tsum([u[:, i] * u[:, i] for i in range(t)])
    b0 = fold([w[:, i, None] * colors[:, i] for i in range(t)])
    b1 = fold([u[:, i, None] * colors[:, i] for i in range(t)])
    det = a11 * a22 - a12 * a12
    ok = torch.abs(det) > 1e-8
    safe = torch.where(ok, det, 1.0)[:, None]
    e0 = (a22[:, None] * b0 - a12[:, None] * b1) / safe
    e1 = (a11[:, None] * b1 - a12[:, None] * b0) / safe
    mean = div(fold([colors[:, i] for i in range(t)]), t)
    e0 = torch.where(ok[:, None], e0, mean)
    e1 = torch.where(ok[:, None], e1, mean)
    return e0, e1
