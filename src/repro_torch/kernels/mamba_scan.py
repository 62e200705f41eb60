"""Mamba-1 selective scan, forward and backward: the port of
``repro.kernels.mamba_scan`` (``mamba_scan_pallas``).

``mamba_scan_plain`` is the recurrence of the reference oracle
(``repro.kernels.ref.mamba_scan_ref``) written step by step in PyTorch; the
CPU path runs it, autograd differentiates it, and on the card it is what
the kernels are held against.  ``mamba_scan_cuda`` is the
``torch.autograd.Function`` :class:`MambaScan` over the two hand-written
CUDA kernels of ``csrc/mamba_scan.cu``: the forward, which also keeps the
state at every ``SCAN_CHUNK``-step boundary, and the backward
(``mamba_scan_bwd_cuda``), which recomputes each chunk's states from them
and sweeps time in reverse.  The reference package has no backward kernel:
its training differentiates the ``lax.scan`` oracle.

Everything is fp32, as the model feeds it.  The CUDA kernels take
d_state == 16 only (every Mamba config of the repository) and raise on
anything else.  ``mamba_scan_cuda.launches`` counts forward launches,
``mamba_scan_bwd_cuda.launches`` backward launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul import _check_cuda

Tensor = torch.Tensor

SCAN_CHUNK = 8      # steps between saved states (kChunk in the CUDA source)
N_STATE = 16        # the d_state the CUDA kernels are written for


def mamba_scan_plain(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                     D: Tensor, *, with_states: bool = False):
    """x, dt (Bt, S, Di); A (Di, N); B, C (Bt, S, N); D (Di,) -> y (Bt, S, Di):
    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t . h_t + D x_t``.
    ``with_states``: (y, states), states (Bt, ceil(S / SCAN_CHUNK), Di, N)
    the state before each chunk's first step, as the forward kernel saves
    them."""
    Bt, S, Di = x.shape
    dA = torch.exp(dt[..., None] * A[None, None])                 # (Bt,S,Di,N)
    dBx = dt[..., None] * B[:, :, None, :] * x[..., None]          # (Bt,S,Di,N)
    h = torch.zeros((Bt, Di, A.shape[1]), dtype=x.dtype, device=x.device)
    ys, states = [], [h] if with_states and S else []
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
        if states and (t + 1) % SCAN_CHUNK == 0 and t + 1 < S:
            states.append(h)
    y = (torch.stack(ys, 1) if ys else torch.zeros_like(x)) + x * D
    if not with_states:
        return y
    return y, (torch.stack(states, 1) if states else
               h.new_zeros((Bt, 0, Di, A.shape[1])))


def mamba_scan_bwd_plain(x: Tensor, dt: Tensor, A: Tensor, B: Tensor,
                         C: Tensor, D: Tensor, states: Tensor | None,
                         dy: Tensor) -> tuple[Tensor, ...]:
    """Autograd through :func:`mamba_scan_plain`: (dx, ddt, dA, dB, dC, dD)
    for the upstream gradient ``dy``.  ``states`` (what the forward kernel
    saved for :func:`mamba_scan_bwd_cuda`) is not needed here."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C, D)]
        y = mamba_scan_plain(*ins)
        return torch.autograd.grad(y, ins, dy)


def n_chunks(S: int) -> int:
    return -(-S // SCAN_CHUNK)


def _check_scan(name: str, x, dt, A, B, C, D):
    """Shapes and dtype of one scan call; returns the inputs contiguous."""
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{name}: x must be (Bt, S, Di) and A (Di, N)")
    Bt, S, Di = x.shape
    N = A.shape[1]
    want = {"x": (x, (Bt, S, Di)), "dt": (dt, (Bt, S, Di)), "A": (A, (Di, N)),
            "B": (B, (Bt, S, N)), "C": (C, (Bt, S, N)), "D": (D, (Di,))}
    for k, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {k} shape {tuple(t.shape)} != {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {k} must be float32, got {t.dtype}")
    if N != N_STATE:
        raise ValueError(f"{name}: the CUDA kernel takes d_state {N_STATE}, "
                         f"got {N}")
    out = {k: t.contiguous() for k, (t, _) in want.items()}
    _check_cuda(name, **out)
    return tuple(out.values())


def _scan_fwd(x, dt, A, B, C, D, *, save_states: bool):
    """Launch the forward kernel: (y, states or None)."""
    name = "mamba_scan"
    x, dt, A, B, C, D = _check_scan(name, x, dt, A, B, C, D)
    Bt, S, Di = x.shape
    y = torch.empty_like(x)
    states = (torch.empty((Bt, n_chunks(S), Di, N_STATE), dtype=x.dtype,
                          device=x.device) if save_states else None)
    if x.numel() == 0:
        return y, states
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mamba_scan_fwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(),
            None if states is None else states.data_ptr(), Bt, S, Di, stream)
    build.check(err, name)
    mamba_scan_cuda.launches += 1
    return y, states


def mamba_scan_bwd_cuda(x: Tensor, dt: Tensor, A: Tensor, B: Tensor,
                        C: Tensor, D: Tensor, states: Tensor,
                        dy: Tensor) -> tuple[Tensor, ...]:
    """CUDA kernel for :func:`mamba_scan_bwd_plain`, from the chunk states
    the forward kernel saved.  dA, dB, dC and dD sum with fp32 atomics, so
    their last bits change from run to run."""
    name = "mamba_scan_bwd"
    x, dt, A, B, C, D = _check_scan(name, x, dt, A, B, C, D)
    Bt, S, Di = x.shape
    st_shape = (Bt, n_chunks(S), Di, N_STATE)
    if states is None or tuple(states.shape) != st_shape:
        raise ValueError(f"{name}: states must be {st_shape}, from the "
                         "forward kernel")
    if tuple(dy.shape) != (Bt, S, Di) or dy.dtype != torch.float32:
        raise ValueError(f"{name}: dy must be a ({Bt}, {S}, {Di}) float32")
    states, dy = states.contiguous(), dy.contiguous()
    _check_cuda(name, states=states, dy=dy)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dB, dC, dD = (torch.zeros_like(t) for t in (A, B, C, D))
    if x.numel() == 0:
        return dx, ddt, dA, dB, dC, dD
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mamba_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), states.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dD.data_ptr(), Bt, S, Di, stream)
    build.check(err, name)
    mamba_scan_bwd_cuda.launches += 1
    return dx, ddt, dA, dB, dC, dD


mamba_scan_bwd_cuda.launches = 0


class MambaScan(torch.autograd.Function):
    """The scan on the card: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        y, states = _scan_fwd(x, dt, A, B, C, D,
                              save_states=any(ctx.needs_input_grad))
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        return mamba_scan_bwd_cuda(*ctx.saved_tensors, dy)


def mamba_scan_cuda(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor,
                    D: Tensor) -> Tensor:
    """CUDA kernels for :func:`mamba_scan_plain`, differentiable."""
    return MambaScan.apply(x, dt, A, B, C, D)


mamba_scan_cuda.launches = 0
