"""Where the fused bf16 FF kernel's time goes, on one card.

    python -m credit_torch.tools.ff_probe

Builds patched copies of `csrc/fused_ff.cu` (one nvcc each, all started
together) into `build/ff_probe/<variant>/` and runs them at the WXFormer's
stage 0 (C = 128, hidden 512, 400 x 720 = 288,000 rows, bf16, pre-norm):

1. in turns (each variant, then each again in reverse order): the kernel as
   it is (`base`); without the GELU, the bias add kept (`no_gelu`: what the
   products and the rest cost); as `no_gelu` with as many erff of values
   that depend on no product, computed while each chunk's products are in
   flight (`busy`: whether that FP32 work runs beside the products); with
   the weights loaded for a block's first tile only (`no_l2`: what
   re-reading them from L2 for every tile costs). The last three compute
   wrong outputs and are only timed;
2. a copy with clock64 stamps at each phase of block 0's consumer
   warpgroups: cycles a tile waiting for x, in the LN, in the first chunk
   (fc1, its wait, the GELU), in the later chunks (their mean), in the
   last fc2, the epilogue and the store.

Nothing here is called by the port.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import subprocess
import sys

from credit_torch import _build

OUT = _build.BUILD_DIR.parent / "ff_probe"
SHAPE = (288000, 128, 512)  # rows, C, hidden
MAX_TILES = 32  # stamped tiles a warpgroup
STAMPS = ["x wait", "LN", "first chunk", "later chunks", "last fc2", "epilogue", "store"]

_GELU = "h[4 * n8 + e] = gelu(h[4 * n8 + e] + (e % 2 ? bb.y : bb.x));"
_BIAS = "h[4 * n8 + e] = h[4 * n8 + e] + (e % 2 ? bb.y : bb.x);"
_EXPECT = "          mbar_expect_tx(&full[s], L::STAGE);\n"
_ISSUED = "        fc1(h);\n        fc2(a);\n        wgmma_wait<1>();\n"
# 32 GELUs a thread, eight at a time (the registers a thread has), of values
# no product gives; the sum goes to shared memory so that none is dropped
_BUSY = ("        fc1(h);\n        fc2(a);\n        {\n          float sum = 0.f;\n"
         "#pragma unroll 1\n          for (int r = 0; r < 4; ++r) {\n"
         "            float d[8];\n#pragma unroll\n            for (int i = 0; i < 8; ++i)\n"
         "              d[i] = gelu(0.01f * (float)(lane + i + 8 * r) - 0.7f + 0.001f * j);\n"
         "#pragma unroll\n            for (int i = 0; i < 8; ++i) sum += d[i];\n          }\n"
         "          if (sum == 12345.f) *reinterpret_cast<float*>(ring) = sum;\n        }\n"
         "        wgmma_wait<1>();\n")
_STAMP = ("#define STAMP(k) if (blockIdx.x == 0 && wt == 0 && it < {n}) "
          "g_stamps[(cw * {n} + it) * 8 + (k)] = clock64();\n").format(n=MAX_TILES)
_READER = ('\nextern "C" int credit_ff_stamps(void* dst) {\n'
           "  return (int)cudaMemcpyFromSymbol(dst, credit::ff::fused::g_stamps,\n"
           "                                   sizeof(credit::ff::fused::g_stamps));\n}\n")


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"ff_probe: the kernel source no longer holds {old!r}")
        text = text.replace(old, new, 1)
    return text


def _stamped(text: str) -> str:
    """The source with clock64 stamps 0-7 per tile and a reader entry."""
    text = _patch(text, [
        ("namespace fused {\n",
         f"namespace fused {{\n__device__ long long g_stamps[3 * {MAX_TILES} * 8];\n" + _STAMP),
        ("      mbar_wait(&xfull[xsl], (it / L::XS) & 1);\n",
         "      STAMP(0) mbar_wait(&xfull[xsl], (it / L::XS) & 1);\n      STAMP(1)\n"),
        ("      // fc1's A: the warpgroup's 64 rows",
         "      STAMP(2)\n      // fc1's A: the warpgroup's 64 rows"),
        ("      activate(h, 0);\n      pack(h, a);\n",
         "      activate(h, 0);\n      pack(h, a);\n      STAMP(3)\n"),
        ("      fc2(a);\n      wgmma_wait<0>();\n      fence_regs(acc);\n      release();\n",
         "      STAMP(4)\n      fc2(a);\n      wgmma_wait<0>();\n      fence_regs(acc);\n"
         "      release();\n      STAMP(5)\n"),
        ("      fence_proxy_async();  // the tile's generic writes",
         "      STAMP(6)\n      fence_proxy_async();  // the tile's generic writes"),
        ("        mbar_arrive(&xempty[xsl]);  // the slot may be loaded again\n      }\n",
         "        mbar_arrive(&xempty[xsl]);  // the slot may be loaded again\n      }\n"
         "      STAMP(7)\n"),
    ])
    return text + _READER


VARIANTS = {
    "base": lambda t: t,
    "no_gelu": lambda t: _patch(t, [(_GELU, _BIAS)]),
    "busy": lambda t: _patch(t, [(_GELU, _BIAS), (_ISSUED, _BUSY)]),
    "no_l2": lambda t: _patch(t, [(_EXPECT, "          if (t != (int)blockIdx.x) {\n"
                                            "            mbar_arrive(&full[s]);\n"
                                            "            continue;\n          }\n" + _EXPECT)]),
    "stamped": _stamped,
}


def build() -> dict:
    """name -> library path of each variant, compiled in parallel."""
    src = (_build.CSRC / "fused_ff.cu").read_text()
    procs = {}
    for name, patch in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / "fused_ff.cu").write_text(patch(src))
        cmd = [_build.nvcc(), *_build.CFLAGS, "-I", str(d), "-shared", "-o", str(d / "lib.so"),
               str(d / "fused_ff.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ff_probe: nvcc failed on {name}:\n{out}")
    return {name: OUT / name / "lib.so" for name in VARIANTS}


def main() -> int:
    import numpy as np
    import torch

    from credit_torch.ops import cuda_ff
    from credit_torch.tools import cuda_ms

    if not torch.cuda.is_available():
        print("ff_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build()
    m, c, hd = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, c), generator=g, device="cuda").to(torch.bfloat16)
    prm = [1 + 0.1 * torch.randn(c, generator=g, device="cuda"),
           0.1 * torch.randn(c, generator=g, device="cuda"),
           torch.randn((c, hd), generator=g, device="cuda") / math.sqrt(c),
           0.02 * torch.randn(hd, generator=g, device="cuda"),
           torch.randn((hd, c), generator=g, device="cuda") / math.sqrt(hd),
           0.02 * torch.randn(c, generator=g, device="cuda")]
    prm = [t.to(torch.bfloat16).contiguous() for t in prm]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = cuda_ff._fused_plan(m, c, hd, sms)
    out = torch.empty_like(x)

    def runner(lib):
        fn = lib.credit_fused_ff
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

        def run():
            err = fn(x.data_ptr(), *(t.data_ptr() for t in prm), out.data_ptr(), _build.BF16,
                     m, c, plan.ld, plan.hidden, 0, plan.grid,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"ff_probe: CUDA error {err}")
        return run

    loaded = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
    timed = [n for n in VARIANTS if n != "stamped"]
    times = {n: [] for n in timed}
    for n in timed + timed[::-1]:
        times[n].append(cuda_ms(runner(loaded[n]), 20))
    print(f"stage 0 (M={m}, C={c}, hidden {hd}, {plan.rows}-row tiles on {plan.grid} blocks), "
          "ms in turns: " + "; ".join(f"{n} {min(t):.4f}-{max(t):.4f}" for n, t in times.items()))

    runner(loaded["stamped"])()
    torch.cuda.synchronize()
    stamps = np.zeros(3 * MAX_TILES * 8, np.int64)
    if loaded["stamped"].credit_ff_stamps(ctypes.c_void_p(stamps.ctypes.data)):
        raise RuntimeError("ff_probe: the stamps could not be read")
    tiles = -(-(-(-m // plan.rows)) // plan.grid)  # block 0's tiles
    chunks = -(-hd // plan.chunk)
    for cw, per in enumerate(stamps.reshape(3, MAX_TILES, 8)):
        if not per[0].any():
            continue
        d = np.diff(per[1:min(tiles, MAX_TILES)], axis=1).astype(float).mean(0)  # steady tiles
        parts = [d[0], d[1], d[2], d[3] / max(chunks - 1, 1), d[4], d[5], d[6]]
        print(f"  warpgroup {cw}: {d.sum():.0f} cycles a tile; " +
              ", ".join(f"{name} {v:.0f}" for name, v in zip(STAMPS, parts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
