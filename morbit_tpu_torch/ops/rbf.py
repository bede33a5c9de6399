"""RBF interpolation: kernels, masked KKT fit, evaluation, Jacobian.

Counterpart of ``morbit_tpu/ops/rbf.py`` (the reference's
``RadialBasisFunctionModels.jl`` use at ``src/models/RbfModel.jl:759-800``),
batched over a leading lane axis. Training sets have a static capacity with
a validity mask: masked rows of the Gram matrix become identity rows, so the
dense KKT solve stays well posed and their weights are exactly zero.

Kernels, written in ``r^2`` (``RbfModel.jl:48-54`` lists the names):

* ``cubic`` (k odd, default 3):            ``(-1)^ceil(k/2) r^k``
* ``gaussian`` (eps, default 1):           ``exp(-(eps*r)^2)``
* ``multiquadric`` (eps):                  ``-(1 + (eps*r)^2)^(1/2)``
* ``inv_multiquadric`` (eps):              ``(1 + (eps*r)^2)^(-1/2)``
* ``thin_plate_spline`` (k, default 2):    ``(-1)^(k+1) r^(2k) log(r)``

The JAX package differentiates the model with ``jax.jacfwd``; here
:func:`rbf_jacobian` is the same chain rule in closed form,
``d phi(|s - x|^2)/dx = -2 phi'(r^2) (s - x)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from morbit_tpu_torch.ops.batched_linalg import GJ_MAX_K, lane_matmul, lane_sum, solve_small

RBF_KERNELS = ("cubic", "multiquadric", "inv_multiquadric", "gaussian",
               "thin_plate_spline")

#: kernels whose parameter is a static exponent, not a shape parameter
EXPONENT_KERNELS = ("cubic", "thin_plate_spline")


#: kernel ids of the CUDA kernels (``csrc/rbf_phi.cuh``)
KERNEL_ID = {"cubic": 0, "multiquadric": 1, "inv_multiquadric": 2,
             "gaussian": 3, "thin_plate_spline": 4}


def phi_constants(kernel: str, static_param):
    """(exponent, coefficient) of the exponent kernels, as
    :func:`apply_kernel` computes them, for the CUDA kernels; unused by the
    smooth kernels."""
    if kernel == "cubic":
        k = float(static_param)
        return k / 2.0, (-1.0) ** -(-k // 2)
    if kernel == "thin_plate_spline":
        k = int(static_param)
        return float(k), 0.5 * ((-1.0) ** (k + 1))
    return 0.0, 0.0


def kernel_default_param(kernel: str) -> float:
    return {"cubic": 3.0, "gaussian": 1.0, "multiquadric": 1.0,
            "inv_multiquadric": 1.0, "thin_plate_spline": 2.0}[kernel]


def _lane_param(param, r2):
    """A per-lane (B,) shape parameter broadcast against ``r2 (B, ...)``."""
    if isinstance(param, torch.Tensor) and param.dim() == 1:
        return param.reshape(param.shape + (1,) * (r2.dim() - 1))
    return param


def apply_kernel(kernel: str, r2: torch.Tensor, param) -> torch.Tensor:
    """phi as a function of r^2. ``param`` is a Python number for
    ``cubic``/``thin_plate_spline``; for the smooth kernels it may also be a
    (B,) tensor of per-lane shape parameters."""
    if kernel == "cubic":
        k = float(param)
        sign = (-1.0) ** -(-k // 2)
        return sign * r2 ** (k / 2.0)
    if kernel == "thin_plate_spline":
        k = int(param)
        safe_r2 = torch.where(r2 > 0, r2, torch.ones_like(r2))
        val = 0.5 * ((-1.0) ** (k + 1)) * r2 ** k * torch.log(safe_r2)
        return torch.where(r2 > 0, val, torch.zeros_like(val))
    p = _lane_param(param, r2)
    if kernel == "gaussian":
        return torch.exp(-(p ** 2) * r2)
    if kernel == "multiquadric":
        return -torch.sqrt(1.0 + p ** 2 * r2)
    if kernel == "inv_multiquadric":
        return 1.0 / torch.sqrt(1.0 + p ** 2 * r2)
    raise ValueError(f"unknown RBF kernel {kernel!r}")


def kernel_derivative(kernel: str, r2: torch.Tensor, param) -> torch.Tensor:
    """d phi / d(r^2), zero at r = 0 where ``jax.jacfwd`` of
    :func:`apply_kernel` is zero."""
    if kernel == "cubic":
        k = float(param)
        sign = (-1.0) ** -(-k // 2)
        return sign * (k / 2.0) * r2 ** (k / 2.0 - 1.0)
    if kernel == "thin_plate_spline":
        k = int(param)
        safe_r2 = torch.where(r2 > 0, r2, torch.ones_like(r2))
        val = 0.5 * ((-1.0) ** (k + 1)) * (
            k * r2 ** (k - 1) * torch.log(safe_r2) + r2 ** (k - 1))
        return torch.where(r2 > 0, val, torch.zeros_like(val))
    p = _lane_param(param, r2)
    p2 = p ** 2
    if kernel == "gaussian":
        return -p2 * torch.exp(-p2 * r2)
    if kernel == "multiquadric":
        return -0.5 * p2 / torch.sqrt(1.0 + p2 * r2)
    if kernel == "inv_multiquadric":
        return -0.5 * p2 / (torch.sqrt(1.0 + p2 * r2) * (1.0 + p2 * r2))
    raise ValueError(f"unknown RBF kernel {kernel!r}")


def poly_dim(n_vars: int, poly_deg: int) -> int:
    """Dimension of the polynomial tail basis (deg in {-1, 0, 1})."""
    if poly_deg < 0:
        return 0
    if poly_deg == 0:
        return 1
    if poly_deg == 1:
        return n_vars + 1
    raise ValueError("polynomial_degree must be -1, 0 or 1")


def poly_basis(x: torch.Tensor, poly_deg: int) -> torch.Tensor:
    """Rows ``[]``, ``[1]`` or ``[1, x...]`` of the polynomial block for
    sites ``x (..., n)`` -> ``(..., poly_dim)``."""
    lead = x.shape[:-1]
    if poly_deg < 0:
        return x.new_zeros(lead + (0,))
    one = x.new_ones(lead + (1,))
    if poly_deg == 0:
        return one
    return torch.cat([one, x], dim=-1)


def pairwise_sqdist(S: torch.Tensor) -> torch.Tensor:
    """(..., P, n) -> (..., P, P) squared distances."""
    d = S[..., :, None, :] - S[..., None, :, :]
    return torch.sum(d * d, dim=-1)


class RbfFit(NamedTuple):
    """Fitted coefficients of a batched vector-valued RBF interpolant (the
    JAX package packs these into two buffers for its loop carries)."""

    sites: torch.Tensor  # (B, P, n)
    mask: torch.Tensor   # (B, P) bool
    w: torch.Tensor      # (B, P, m)
    lam: torch.Tensor    # (B, pd, m)
    param: torch.Tensor  # (B,) shape parameter the model was fitted with


def fit_rbf(sites, values, mask, kernel: str = "cubic", param=None,
            poly_deg: int = 1, reg: float = 0.0) -> RbfFit:
    """Solve ``[Phi Pi; Pi' 0][w; lam] = [V; 0]`` per lane (``fit_rbf``,
    ``morbit_tpu/ops/rbf.py:149-254``): the same centering by ``c``,
    scaling by ``alpha`` and residual-checked ridge fallback.

    ``sites`` (B, P, n), ``values`` (B, P, m), ``mask`` (B, P); ``param`` a
    number or a (B,) tensor (smooth kernels only)."""
    B, P, n = sites.shape
    m = values.shape[-1]
    dtype, dev = sites.dtype, sites.device
    if param is None:
        param = kernel_default_param(kernel)
    np_ = poly_dim(n, poly_deg)

    mm = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(P, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    if dtype == torch.float32 and P >= 128:
        # the wide-n path: K4, as the JAX package routes its Pallas kernel
        # (rbf.py:181-187); the twin of the same formula on the CPU.
        # Imported here because dense_kernels imports this module.
        from morbit_tpu_torch.ops.dense_kernels import rbf_gram_matrix

        Phi = rbf_gram_matrix(sites.contiguous(), mask.contiguous(), kernel, param)
    else:
        Phi = torch.where(mm, apply_kernel(kernel, pairwise_sqdist(sites), param), eye)
    n_valid = mask.sum(-1).to(dtype)

    # conditioning: centering removes the dominant rank-one part when the
    # tail holds the constant; alpha factors out a global scale
    if np_ > 0:
        c = (lane_sum(torch.where(mm, Phi, zero))
             / torch.clamp(n_valid ** 2, min=1.0))
        Phi_c = Phi - c[:, None, None]
    else:
        Phi_c = Phi
    alpha = torch.clamp(torch.where(mm, Phi_c, zero).abs().amax((-1, -2)),
                        min=1e-30)
    Phi_s = torch.where(mm, Phi_c / alpha[:, None, None], eye)

    if np_ > 0:
        Pi = torch.where(mask[..., None], poly_basis(sites, poly_deg), zero)

        def kkt(extra_reg):
            tail = -(extra_reg * torch.eye(np_, dtype=dtype, device=dev))
            top = torch.cat([Phi_s, Pi], dim=-1)
            bottom = torch.cat([Pi.transpose(-1, -2),
                                tail.expand(B, np_, np_)], dim=-1)
            return torch.cat([top, bottom], dim=-2)

        rhs = torch.cat([torch.where(mask[..., None], values, zero),
                         values.new_zeros((B, np_, m))], dim=-2)
    else:
        def kkt(extra_reg):
            return Phi_s + extra_reg * eye

        rhs = torch.where(mask[..., None], values, zero)

    K = kkt(reg)
    sol = solve_small(K, rhs)
    resid = ((lane_matmul(K, sol) - rhs).abs().amax((-1, -2))
             / (rhs.abs().amax((-1, -2)) + 1.0))
    eps = torch.finfo(dtype).eps
    tol = 1e2 * torch.sqrt(torch.tensor(eps, dtype=dtype))
    bad = (~torch.isfinite(sol).all(-1).all(-1)) | (resid > tol)
    ridge = max(reg, 1e2 * float(eps))
    # past the unrolled size the second solve runs only when some lane needs
    # it (one host sync), as the JAX package gates it (rbf.py:235-249); its
    # values are the same either way
    if K.shape[-1] <= GJ_MAX_K or bool(bad.any()):
        sol2 = solve_small(kkt(ridge), rhs)
        sol = torch.where(bad[:, None, None], sol2, sol)

    w = torch.where(mask[..., None], sol[:, :P] / alpha[:, None, None], zero)
    lam = sol[:, P:]
    param_t = torch.as_tensor(param, dtype=dtype, device=dev).expand(B).clone()
    return RbfFit(sites=sites, mask=mask, w=w, lam=lam, param=param_t)


def _eval_param(fit: RbfFit, kernel: str, param):
    if param is not None:
        return param
    if kernel in EXPONENT_KERNELS:
        return kernel_default_param(kernel)
    return fit.param


#: elements of the (B, K, P, n) differences that :func:`eval_rbf` forms at
#: once: a larger K is taken in slices of query sites (the backtracking
#: ladder of the 50-variable ZDT path at B=1024 would take ~17 GB at once)
EVAL_CHUNK_ELEMS = 1 << 28


def _sites_axes(fit: RbfFit, X: torch.Tensor):
    """Flatten query sites ``X (B, ..., n)`` to (B, K, n) and return the
    differences ``s_i - x`` (B, K, P, n) and their squared norms."""
    B, n = X.shape[0], X.shape[-1]
    Xf = X.reshape(B, -1, n)
    d = fit.sites[:, None, :, :] - Xf[:, :, None, :]
    return Xf, d, torch.sum(d * d, dim=-1)


def _sq_dists(fit: RbfFit, Xf: torch.Tensor) -> torch.Tensor:
    """(B, K, P) squared norms of ``s_i - x``, the differences formed a
    slice of query sites at a time within ``EVAL_CHUNK_ELEMS``; each entry
    is the same torch expression as in :func:`_sites_axes`."""
    B, K, n = Xf.shape
    step = max(1, EVAL_CHUNK_ELEMS // max(1, B * fit.sites.shape[1] * n))
    if K <= step:
        return _sites_axes(fit, Xf)[2]
    return torch.cat([_sites_axes(fit, Xf[:, k:k + step])[2] for k in range(0, K, step)],
                     dim=1)


def eval_rbf(fit: RbfFit, X: torch.Tensor, kernel: str, poly_deg: int,
             param=None) -> torch.Tensor:
    """Model values at scaled sites ``X (B, ..., n)`` -> ``(B, ..., m)``."""
    Xf = X.reshape(X.shape[0], -1, X.shape[-1])
    r2 = _sq_dists(fit, Xf)
    phi = apply_kernel(kernel, r2, _eval_param(fit, kernel, param))
    phi = torch.where(fit.mask[:, None, :], phi, torch.zeros_like(phi))
    out = lane_matmul(phi, fit.w)                      # (B, K, m)
    if fit.lam.shape[-2] > 0:
        out = out + lane_matmul(poly_basis(Xf, poly_deg), fit.lam)
    return out.reshape(X.shape[:-1] + (fit.w.shape[-1],))


def rbf_jacobian(fit: RbfFit, x: torch.Tensor, kernel: str, poly_deg: int,
                 param=None) -> torch.Tensor:
    """(B, m, n) Jacobian of the model at one scaled site per lane."""
    _, d, r2 = _sites_axes(fit, x[:, None, :])
    dphi = kernel_derivative(kernel, r2, _eval_param(fit, kernel, param))
    dphi = torch.where(fit.mask[:, None, :], dphi, torch.zeros_like(dphi))
    # d phi(|s_i - x|^2) / dx = -2 phi'(r2_i) (s_i - x)
    grad_phi = -2.0 * dphi[..., None] * d                # (B, 1, P, n)
    J = lane_matmul(fit.w.transpose(-1, -2), grad_phi[:, 0])
    if poly_deg == 1:
        J = J + fit.lam[:, 1:, :].transpose(-1, -2)
    return J
