"""Kernel D: GICP's Levenberg-Marquardt lambda search in one launch
(``csrc/lm_search.cu``), and its plain version.

D replaces no Pallas kernel: the JAX package runs the search as a
``lax.while_loop`` (``noetic_slam_tpu/ops/gicp.py``, ``inner_lm``). The
port used to run it as ``lm_max_iterations`` masked iterations of small
PyTorch ops. Until the step that ends the search, its lambda schedule does
not depend on the data: from lambda_0 and nu = 2 each reject sets
lambda <- nu lambda and nu <- 2 nu, so candidate k has
lambda_k = lambda_0 * 2^(k(k+1)/2), exact in f32, and x0, y0, H and b stay
fixed. So all K candidates are solved and scored in one pass over the
pairs, and the sequential loop's result is a scan over k. Design and what
bounds it: the note at the top of ``csrc/lm_search.cu``.

``lm_search`` takes a CUDA tensor to kernel D (``lm_search_fused``; it
raises rather than fall back) and a CPU tensor to ``lm_search_plain``,
the same candidate formulation in PyTorch: a batched (K, 6, 6) solve,
(K, 4, 4) transforms, one (K, N) error pass, the carry over k.

Contract, shared by both: ``(accepted, x, lam, dT, y, converged, stop, k)``
as the masked loop ``for k < K`` gives it (tests/test_torch_lm_search.py
keeps that loop as the oracle):
- lambda starts at ``init_lambda_factor * max|diag H|`` when ``lam_in`` is
  negative, else at ``lam_in``;
- candidate k: d_k solves (H + lambda_k I) d = -b, delta_k = exp(d_k),
  xi_k = delta_k x0, y_k = sum e^T M e at xi_k, rho_k =
  (y0 - y_k) / d_k.(lambda_k d_k - b);
- the first k with rho_k >= 0 (an accept: x = xi_k, y = y_k, lambda =
  lambda_k max(1/3, 1 - (2 rho_k - 1)^3)) or with rho_k < 0 and delta_k
  below the convergence thresholds (lambda = nu lambda_k, x0 and y0 kept)
  ends the search with ``accepted``; with none in K, x0, y0 and
  lambda_0 2^(K(K+1)/2) stay, and ``accepted`` is false;
- ``dT`` is the last delta evaluated (the identity when K is 0),
  ``converged = accepted & dT below the thresholds``, ``stop = converged
  | ~accepted`` (the outer loop's exit), ``k`` the candidate that ended
  the search (K when none did).

``error_sums`` sums in kernel D's order, so the plain error at the
kernel's x equals the kernel's y bitwise; ``ops.gicp.compute_error`` is
``error_sums`` at one transform.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from noetic_slam_tpu_torch.ops.cuda import _build
from noetic_slam_tpu_torch.ops.pointcloud import const
from noetic_slam_tpu_torch.utils.geometry import quat_to_mat, so3_exp_quat

Tensor = torch.Tensor

KMAX = 16          # most candidates a launch takes; KMAX in csrc/lm_search.cu
THREADS = 256      # threads a block; THREADS in csrc/lm_search.cu
PPT = 4            # pairs a thread; PPT in csrc/lm_search.cu
WARPS = THREADS // 32
BLOCK_PAIRS = THREADS * PPT
_OUT_WORDS = 36    # the kernel's output buffer (f32 words)


class LmResult(NamedTuple):
    accepted: Tensor   # () bool: a step ended the search
    x: Tensor          # (4, 4) the transform after the search
    lam: Tensor        # () lambda for the next search
    dT: Tensor         # (4, 4) the last delta evaluated
    y: Tensor          # () the error at x
    converged: Tensor  # () bool: accepted and dT below the thresholds
    stop: Tensor       # () bool: converged or not accepted
    k: Tensor          # () int32: the candidate that ended it; K if none


def delta_to_T(d: Tensor) -> Tensor:
    """6-vectors (..., 6) -> SE(3) (..., 4, 4): rotation exp(d[:3]),
    translation d[3:]."""
    top = torch.cat([quat_to_mat(so3_exp_quat(d[..., :3])), d[..., 3:, None]],
                    dim=-1)
    bottom = const(((0.0, 0.0, 0.0, 1.0),), d.device)
    return torch.cat([top, bottom.expand(d.shape[:-1] + (1, 4))], dim=-2)


def is_converged(delta_T: Tensor, rot_eps: float, trans_eps: float
                 ) -> Tensor:
    """max|R - I| / rot_eps and max|t| / trans_eps both below 1."""
    R = delta_T[:3, :3] - torch.eye(3, dtype=delta_T.dtype,
                                    device=delta_T.device)
    r_delta = torch.max(torch.abs(R)) / rot_eps
    t_delta = torch.max(torch.abs(delta_T[:3, 3])) / trans_eps
    return torch.maximum(r_delta, t_delta) < 1.0


def error_sums(src_xyz: Tensor, tgt_rows: Tensor, maha: Tensor, T: Tensor
               ) -> Tensor:
    """sum over the pairs of e^T M e, e = tgt_rows - (R src + t), at each
    transform of T (..., 4, 4): (...). Each term is rounded operation by
    operation in kernel D's order, and the terms are summed as D sums
    them: pairs g * 1024 + j * 256 + w * 32 + l (block g, j, warp w, lane
    l; zeros past N) added over j in order, then over the lanes and the
    warps by halving, then over the blocks in order. Every step is
    elementwise, so a candidate's sum does not depend on the batch."""
    px, py, pz = src_xyz.unbind(-1)
    R, tr = T[..., :3, :3, None], T[..., :3, 3, None]
    e = [tgt_rows[:, r] - ((R[..., r, 0, :] * px + R[..., r, 1, :] * py
                            + R[..., r, 2, :] * pz) + tr[..., r, :])
         for r in range(3)]
    Me = [maha[:, r, 0] * e[0] + maha[:, r, 1] * e[1] + maha[:, r, 2] * e[2]
          for r in range(3)]
    q = e[0] * Me[0] + e[1] * Me[1] + e[2] * Me[2]            # (..., N)
    n = q.shape[-1]
    blocks = max(1, -(-n // BLOCK_PAIRS))
    q = torch.nn.functional.pad(q, (0, blocks * BLOCK_PAIRS - n))
    q = q.reshape(q.shape[:-1] + (blocks, PPT, WARPS, 32))
    a = q[..., 0, :, :]
    for j in range(1, PPT):
        a = a + q[..., j, :, :]
    for h in (16, 8, 4, 2, 1):
        a = a[..., :h] + a[..., h:2 * h]
    a = a[..., 0]                                       # (..., blocks, 8)
    for h in (4, 2, 1):
        a = a[..., :h] + a[..., h:2 * h]
    a = a[..., 0]                                       # (..., blocks)
    s = a[..., 0]
    for g in range(1, blocks):
        s = s + a[..., g]
    return s


def lm_search(cfg, src_xyz: Tensor, tgt_rows: Tensor, maha: Tensor,
              H: Tensor, b: Tensor, y0: Tensor, x0: Tensor, lam_in: Tensor
              ) -> LmResult:
    """One LM lambda search (module docstring): kernel D for CUDA tensors,
    the plain version for CPU tensors. ``cfg`` is the ``GicpConfig``."""
    if src_xyz.is_cuda:
        return lm_search_fused(cfg, src_xyz, tgt_rows, maha, H, b, y0, x0,
                               lam_in)
    return lm_search_plain(cfg, src_xyz, tgt_rows, maha, H, b, y0, x0,
                           lam_in)


def lm_search_plain(cfg, src_xyz: Tensor, tgt_rows: Tensor, maha: Tensor,
                    H: Tensor, b: Tensor, y0: Tensor, x0: Tensor,
                    lam_in: Tensor) -> LmResult:
    """The plain version: every candidate solved and scored at once, then
    the masked loop's carry over k."""
    dev, dtype = src_xyz.device, src_xyz.dtype
    K = cfg.lm_max_iterations
    lam = torch.where(lam_in < 0.0,
                      cfg.init_lambda_factor * torch.max(torch.abs(
                          torch.diagonal(H))), lam_in)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    lams = []
    for _ in range(K):
        lams.append(lam)
        lam, nu = nu * lam, 2.0 * nu
    accepted = torch.zeros((), dtype=torch.bool, device=dev)
    x, y = x0, y0
    dT = torch.eye(4, dtype=dtype, device=dev)
    k_end = torch.full((), K, dtype=torch.int32, device=dev)
    if K:
        lam_k = torch.stack(lams)
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        # contiguous rows: torch.dot sums a strided vector in another order
        d = torch.linalg.solve_ex(H + lam_k[:, None, None] * eye6,
                                  -b)[0].contiguous()
        delta = delta_to_T(d)
        xi = delta @ x0
        yi = error_sums(src_xyz, tgt_rows, maha, xi)
        lam = lam_k[0]
        nu = torch.full((), 2.0, dtype=dtype, device=dev)
        done = accepted
        for k in range(K):
            rho = (y0 - yi[k]) / torch.dot(d[k], lam * d[k] - b)
            reject = rho < 0
            conv_on_reject = reject & is_converged(
                delta[k], cfg.rotation_epsilon, cfg.transformation_epsilon)
            lam_new = torch.where(
                reject, nu * lam,
                lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                  min=1.0 / 3.0))
            nu_new = torch.where(reject, 2.0 * nu, 2.0)
            step_done = ~reject | conv_on_reject
            # a finished search keeps its carry
            lam = torch.where(done, lam, lam_new)
            nu = torch.where(done, nu, nu_new)
            x = torch.where(done | reject, x, xi[k])
            y = torch.where(done | reject, y, yi[k])
            dT = torch.where(done, dT, delta[k])
            accepted = torch.where(done, accepted, step_done)
            k_end = torch.where(~done & step_done, k, k_end)
            done = done | step_done
    converged = accepted & is_converged(dT, cfg.rotation_epsilon,
                                        cfg.transformation_epsilon)
    return LmResult(accepted, x, lam, dT, y, converged,
                    converged | ~accepted, k_end)


# (device, stream) -> (counters: int32 [ticket, tally 0..KMAX], partials)
_workspaces: dict = {}


def _workspace(dev: torch.device, stream: int, blocks: int):
    ws = _workspaces.get((dev, stream))
    if ws is None or ws[1].numel() < blocks * KMAX:
        counters = (ws[0] if ws is not None else
                    torch.zeros(2 + KMAX, dtype=torch.int32, device=dev))
        partials = torch.empty(max(blocks, 8) * KMAX, dtype=torch.float32,
                               device=dev)
        ws = _workspaces[(dev, stream)] = (counters, partials)
    return ws


def _on(dev) -> list:
    """The workspaces' counters on card ``dev`` (``cuda`` is the current
    card), every stream."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return [counters for (d, _), (counters, _) in _workspaces.items()
            if d.index == index]


def tally(dev) -> list[int]:
    """Searches on card ``dev`` that ended at candidate k, k < KMAX, then
    those that ended with none: KMAX + 1 counts (a host read)."""
    out = [0] * (KMAX + 1)
    for counters in _on(dev):
        out = [a + b for a, b in zip(out, counters[1:].tolist())]
    return out


def reset_tally(dev) -> None:
    for counters in _on(dev):
        counters[1:].zero_()


def _operand(name: str, x: Tensor, shape: tuple) -> Tensor:
    if not x.is_cuda:
        raise ValueError(f"lm_search: {name} must be a CUDA tensor")
    if x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(f"lm_search: {name} must be float32 {shape}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def lm_search_fused(cfg, src_xyz: Tensor, tgt_rows: Tensor, maha: Tensor,
                    H: Tensor, b: Tensor, y0: Tensor, x0: Tensor,
                    lam_in: Tensor) -> LmResult:
    """Kernel D: one launch, its outputs views of one 36-word buffer;
    nothing is read back to the host. CUDA tensors only (float32); raises
    on anything else and when ``cfg.lm_max_iterations`` passes ``KMAX``
    (no fallback). ``launches`` counts calls."""
    K = cfg.lm_max_iterations
    if not 0 <= K <= KMAX:
        raise ValueError(f"lm_search: lm_max_iterations {K} outside "
                         f"0..{KMAX}")
    n = src_xyz.shape[0]
    ops = [_operand(name, x, shape) for name, x, shape in (
        ("src_xyz", src_xyz, (n, 3)), ("tgt_rows", tgt_rows, (n, 3)),
        ("maha", maha, (n, 3, 3)), ("H", H, (6, 6)), ("b", b, (6,)),
        ("y0", y0, ()), ("x0", x0, (4, 4)), ("lam_in", lam_in, ()))]
    dev = src_xyz.device
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters, partials = _workspace(dev, stream,
                                        max(1, -(-n // BLOCK_PAIRS)))
        out = torch.empty(_OUT_WORDS, dtype=torch.float32, device=dev)
        ticket = counters.data_ptr()
        err = lib.nst_lm_search_launch(
            *(x.data_ptr() for x in ops[:3]), n,
            *(x.data_ptr() for x in ops[3:]), K,
            float(cfg.init_lambda_factor), float(cfg.rotation_epsilon),
            float(cfg.transformation_epsilon), partials.data_ptr(), ticket,
            ticket + 4, out.data_ptr(), stream)
    _build.check(err, "lm_search")
    lm_search_fused.launches += 1
    flags = out[34:35].view(torch.uint8).view(torch.bool)
    return LmResult(flags[0], out[:16].view(4, 4), out[16],
                    out[17:33].view(4, 4), out[33], flags[1], flags[2],
                    out[35:36].view(torch.int32)[0])


lm_search_fused.launches = 0


def kernel_shape() -> dict:
    """The built kernel's shape: the most candidates and the pairs a block."""
    lib = _build.load()
    return {"kmax": lib.nst_lm_search_kmax(),
            "block_pairs": lib.nst_lm_search_block_pairs()}
