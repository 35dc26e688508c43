"""Windowed multi-head attention with one shared (T, T) f32 bias (kernel 3).

The port of credit_tpu/ops/pallas_attention.py `fused_window_attention`.
`fused_window_attention` launches the hand-written CUDA kernels
(`csrc/window_attention.cu`) for CUDA tensors and runs
`fused_window_attention_plain` for CPU tensors; `attention_plan` picks the
kernel and its sizes per shape in Python. Numerics follow the TPU kernel:
q scaled in its own dtype, f32 scores plus the f32 bias, a safe softmax in
f32 with exact division, probabilities cast to v's dtype, P.V accumulated
in f32, output in the input dtype. Windows whose keys pass one key block
(T > 128 in bf16 on the tensor cores; past shared memory on the FMA kernel)
take an online softmax over key blocks: a running max and sum in f32,
exp(s - max) cast to v's dtype before P.V, one division at the end.

`fused_window_attention_diff` makes it differentiable. credit_tpu has no
Pallas backward for attention (its training differentiates the jnp route
with XLA's autodiff), so the backward here is autograd of the plain version,
recomputed from the saved q, k, v and bias; the forward stays on the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from credit_torch import _build

SMS = 132  # an H100's multiprocessors, for plans made without a card
MAX_SMEM = 232448  # shared memory a block may use (csrc/common.cuh kMaxSmem)
SM_SMEM = 233472  # shared memory of one SM; each resident block also holds 1 KB
MMA_HEAD_WIDTHS = (16, 32, 64, 128)
MMA_KEY_BLOCK = 64  # keys a block past one block (csrc MULTI_KT = 4 tiles of 16)
MAX_SLOTS = 4
FMA_THREADS, FMA_ROWS = 256, 4
FMA_BLOCKS_PER_SM = 6  # csrc: the FMA kernel's launch bound


def fused_window_attention_plain(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The same function in plain PyTorch. q, k, v (B, nWin, T, heads*dh)."""
    b, nwin, t, inner = q.shape
    dh = inner // num_heads

    def split(z):  # (b, n, t, h*dh) -> (b, n, h, t, dh)
        return z.reshape(b, nwin, t, num_heads, dh).transpose(2, 3)

    qs = split(q * torch.tensor(dh ** -0.5, dtype=q.dtype))
    sim = qs.float() @ split(k).float().transpose(-1, -2) + bias.float()
    sim = sim - sim.amax(dim=-1, keepdim=True)
    p = torch.exp(sim)
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = (p.float() @ split(v).float()).to(q.dtype)
    return out.transpose(2, 3).reshape(b, nwin, t, inner)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _mma_caps(dh: int):
    """The mma kernel's consumer warps at most and the (head, row tile)
    pairs a warp holds over key blocks (csrc `Mma<DH>`)."""
    return (14 if dh <= 32 else 8), (1 if dh >= 128 else 2)


def _fma_smem(t: int, kb: int, dh: int) -> int:
    """csrc `fma_smem`: one key block's k and v, per warp its rows of q and
    of output sums with their running max and sum (FMA_ROWS rows in the
    online form, one in the exact form), and a row of scores, f32."""
    rows = 1 if kb >= t else FMA_ROWS
    return (2 * kb * (dh + 1) + FMA_THREADS // 32 * (2 * rows * (dh + 1) + kb)) * 4


@dataclass(frozen=True)
class AttnPlan:
    """How one `fused_window_attention` call runs. kernel: "mma" (bf16 on
    the tensor cores, TMA rings) or "fma". heads_per_item: heads a work item
    holds (64 or 128 columns; fma: 1). windows_per_item: a pack of windows
    (T <= 8), else 1. row_tiles: 16-row query tiles an item. key_block and
    key_blocks: keys a staged block and blocks a window (one: the exact
    softmax; more: the online form). consumers: consumer warps a block (fma:
    its 8 warps). slots: stages of each ring (fma: 1). grid: blocks. smem:
    bytes of dynamic shared memory a block."""

    kernel: str
    heads_per_item: int
    windows_per_item: int
    row_tiles: int
    key_block: int
    key_blocks: int
    consumers: int
    slots: int
    grid: int
    smem: int


@functools.lru_cache(maxsize=1024)
def attention_plan(windows: int, t: int, dh: int, heads: int, dtype: torch.dtype,
                   strides: tuple = (0, 0), aligned: bool = True, sms: int = SMS) -> AttnPlan:
    """The kernel and its sizes for `windows` windows of t tokens, heads of
    dh, q/k/v and out token strides `strides` (elements), 16-byte aligned
    pointers or not.

    mma (bf16, dh 16-128, strides multiples of 8, aligned, heads that group
    into 128 or 64 columns): T <= 128 is one key block of 16 ceil(T / 16)
    keys (T <= 8: a pack of 16 // T windows in one 16-row tile), every query
    tile of the window in one item; T > 128 takes key blocks of 64 and query
    blocks of up to 8 16-row tiles, as many as the consumer warps hold, as
    few blocks as that allows and as even as they go. The consumers share
    the item's pairs evenly; each ring takes as many stages (2-4) as shared
    memory holds; the grid is the blocks that fit on the SMs at once by
    shared memory, threads and the launch bound's registers, capped at the
    items. fma (row_tiles 0): the exact form when one block of keys fits in
    shared memory, else the largest block of a multiple of 32 keys that
    does; as many blocks as are resident at once (the blocks walk the
    problems: blocks left for a second wave would double the time), capped
    at the problems."""
    in_stride, out_stride = strides
    gc = 0
    if (dtype == torch.bfloat16 and dh in MMA_HEAD_WIDTHS and aligned
            and in_stride % 8 == 0 and out_stride % 8 == 0):
        for cols in (128, 64):
            if cols % dh == 0 and heads % (cols // dh) == 0:
                gc = cols
                break
    if gc == 0:
        kb = t
        if _fma_smem(t, kb, dh) > MAX_SMEM:
            kb = max(32, (MAX_SMEM // 4 - 8 * 2 * FMA_ROWS * (dh + 1)) // (2 * (dh + 1) + 8)
                     // 32 * 32)
        if _fma_smem(t, kb, dh) > MAX_SMEM:
            raise ValueError(f"fused_window_attention: heads of {dh} do not fit the FMA kernel")
        smem = _fma_smem(t, kb, dh)
        per_sm = min(FMA_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))
        return AttnPlan("fma", 1, 1, 0, kb, _cdiv(t, kb), FMA_THREADS // 32, 1,
                        min(windows * heads, sms * per_sm), smem)
    hg = gc // dh
    cap, pmax = _mma_caps(dh)
    if t <= 128:
        wpi = 16 // t if t <= 8 else 1
        rt = _cdiv(wpi * t, 16)
        kb = 16 * rt
        nq, nkb = 1, 1
        pairs = hg * rt
        per = _cdiv(pairs, min(cap, pairs))
        consumers = _cdiv(pairs, per)
    else:
        wpi, kb = 1, MMA_KEY_BLOCK
        tiles = _cdiv(t, 16)
        nq = _cdiv(tiles, min(8, cap * pmax // hg))
        rt = _cdiv(tiles, nq)  # the fewest query blocks, as even as they go
        nkb = _cdiv(t, kb)
        consumers = _cdiv(hg * rt, pmax)
    qbytes = gc // 64 * 16 * rt * 128
    kvbytes = 2 * gc // 64 * kb * 128
    table = 16 * rt * (16 * rt + 8) * 4 if nkb == 1 else 0

    def smem(slots: int) -> int:
        return 1024 + slots * (qbytes + kvbytes) + table + 4 * slots * 8

    slots = 2
    while slots < MAX_SLOTS and smem(slots + 1) <= MAX_SMEM:
        slots += 1
    if smem(slots) > MAX_SMEM:
        raise ValueError(f"fused_window_attention: no stage ring fits at T={t}, dh={dh}")
    threads = 32 * (consumers + 1)
    # the most registers the kernel's launch bound lets ptxas take
    launch_bound_regs = 65536 // (32 * (cap + 1)) // 8 * 8
    per_sm = min(SM_SMEM // (smem(slots) + 1024), 2048 // threads,
                 65536 // (threads * launch_bound_regs))
    items = _cdiv(windows, wpi) * (heads // hg) * nq
    return AttnPlan("mma", hg, wpi, rt, kb, nkb, consumers, slots,
                    min(items, sms * max(1, per_sm)), smem(slots))


def fused_window_attention(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """q, k, v: (B, nWin, T, heads*dh), each with unit stride over its last
    dim and one token stride (views of one fused qkv projection are taken
    as they are); bias (T, T). Returns a new (B, nWin, T, heads*dh). Any T
    and dh, on the kernel `attention_plan` picks (csrc/window_attention.cu)."""
    if q.device.type == "cpu":
        return fused_window_attention_plain(q, k, v, bias, num_heads)
    b, nwin, t, inner = q.shape
    dh = inner // num_heads
    if dh * num_heads != inner:
        raise ValueError(f"fused_window_attention: {inner} channels do not split into "
                         f"{num_heads} heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("fused_window_attention: q, k, v must share a dtype")

    def token_stride(z):
        # rows of (B*nWin*T) tokens, one stride, unit stride inside a row
        if z.shape != q.shape:
            raise ValueError("fused_window_attention: q, k, v shapes differ")
        if z.stride(-1) != 1 or z.stride(-3) != t * z.stride(-2) or z.stride(0) != nwin * t * z.stride(-2):
            z = z.contiguous()
        return z, z.stride(-2)

    (q, sq), (k, sk), (v, sv) = token_stride(q), token_stride(k), token_stride(v)
    if not sq == sk == sv:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        sq = inner
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, nwin, t, inner), dtype=q.dtype, device=q.device)
    aligned = all(z.data_ptr() % 16 == 0 for z in (q, k, v, out))
    plan = attention_plan(b * nwin, t, dh, num_heads, q.dtype, (sq, inner), aligned,
                          torch.cuda.get_device_properties(q.device).multi_processor_count)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("credit_window_attention",
                         [p] * 5 + [i] * 7 + [ctypes.c_float] + [i] * 8 + [p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
             _build.dtype_code(q.dtype), b * nwin, num_heads, t, dh, sq, inner,
             float(torch.tensor(dh ** -0.5, dtype=torch.float32)),
             1 if plan.kernel == "mma" else 0, plan.heads_per_item, plan.windows_per_item,
             plan.row_tiles, plan.key_block, plan.consumers, plan.slots, plan.grid,
             _build.stream_ptr())
    _build.check(err, "credit_window_attention")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0


class _WindowAttention(torch.autograd.Function):
    """Forward: kernel 3. Backward: autograd of the plain version,
    recomputed from the saved inputs (the gradient of the bias flows on into
    the dynamic position bias)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.num_heads = num_heads
        return fused_window_attention(q, k, v, bias, num_heads)

    @staticmethod
    def backward(ctx, gout):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = fused_window_attention_plain(*ins, ctx.num_heads)
            grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], gout))
        return (*(next(grads) if n else None for n in need), None)


def fused_window_attention_diff(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """Differentiable `fused_window_attention` (see the module note)."""
    return _WindowAttention.apply(q, k, v, bias, num_heads)
