"""Where a WKV6 block spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.launch.wkv6_phases
    PYTHONPATH=src python -m repro_torch.launch.wkv6_phases --serial PATH

Copies the package into ``build/wkv6_phases/`` (git-ignored) and adds
``clock64()`` stamps at the phase boundaries of the WKV6 kernel in the copy;
then, in a child process, builds the copy and runs rwkv6-7b's heads (64 of
64) in bfloat16 at the smoke's ``served_512`` (B 1, T 512) and
``long_4096`` (B 8, T 4096) shapes, and prints the median over blocks of
each phase's cycles and the card's SM clock.

Without ``--serial`` it stamps the package's own chunked kernel
(``rwkv6_wkv/csrc/wkv6.cu``, ``wkv6_chunked``): per chunk of 64 steps, for
thread 0 (warp 0: the decays within sub-chunks, then y's rows 0-15) and
thread 224 (warp 7: v and the pairs within sub-chunks, then rows 48-63, the
most A V work): the wait for the chunk's copies, that warp's part of the
chunk's preparation, the barrier, y's state term, A between sub-chunks, the
barrier, A V and y out, the state update.  With
``--serial PATH`` it stamps the serial form of the kernel in the file at
PATH (``wkv6_kernel``, which walks time one step after another; e.g. the
source as of git commit 9a3ffc1, ``git show 9a3ffc1:src/repro_torch/
kernels/rwkv6_wkv/csrc/wkv6.cu``) in place of the package's: per chunk of
16 steps the wait and barrier, the conversion pass, and per step the loads
and FMAs, the two shuffles and y's store to shared memory, then the
chunk's y out.  A stamp waits for the value it follows (a ``mov`` of the
last result), so a phase ends when its results exist.  The stamps cost a
clock read and a few instructions at each boundary, per step in the serial
form; the package's own kernel has none.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(os.path.dirname(os.path.dirname(PKG)), "build", "wkv6_phases")
CU = os.path.join("kernels", "rwkv6_wkv", "csrc", "wkv6.cu")
CHUNKED = ["wait for the chunk", "prep (warp 0: decays in sub-chunks; warp 7: v, pairs "
           "in sub-chunks)", "barrier", "y state term", "A between sub-chunks", "barrier",
           "A V, y out", "state update"]
SERIAL = ["wait, barrier", "conversion pass", "step: loads, FMAs",
          "step: shuffles", "step: y to shared", "barrier", "y out"]
WHO = 2        # stamped threads per block
SLOTS = 16


def _put(text: str, anchor: str, code: str, before: bool = True) -> str:
    assert text.count(anchor) == 1, anchor
    return text.replace(anchor, code + anchor if before else anchor + code)


def _stamp(k: int, dep: str = "") -> str:
    wait = (f'  {{ unsigned d_; asm volatile("mov.b32 %0, %1;" : "=r"(d_) : '
            f'"f"({dep})); }}\n') if dep else ""
    return (wait + f"  {{ const long long n_ = clock64(); st_acc[{k}] += n_ - st_last; "
            "st_last = n_; }\n")


def _frame(src: str, first: str, last: str, who: str) -> str:
    """Declare the accumulators before ``first`` and store them after
    ``last``; ``who`` is the condition and row of a stamped thread."""
    src = _put(src, "namespace {\n",
               f"__device__ long long g_stamp[65536][{WHO}][{SLOTS}];\n"
               f"__device__ int g_rounds[65536];\n", before=False)
    src = _put(src, first, f"  long long st_acc[{SLOTS}] = {{0}};\n"
               "  long long st_last = clock64();\n  int st_rounds = 0;\n")
    store = (f"  {{ const int st_who = {who};\n"
             "    if (st_who >= 0) {\n"
             f"      for (int i_ = 0; i_ < {SLOTS}; ++i_)\n"
             "        g_stamp[blockIdx.y * gridDim.x + blockIdx.x][st_who][i_] = st_acc[i_];\n"
             "      g_rounds[blockIdx.y * gridDim.x + blockIdx.x] = st_rounds;\n"
             "    } }\n")
    src = _put(src, last, store, before=False)
    return src + ('\nextern "C" int repro_wkv6_stamps(void* host, void* rounds) {\n'
                  "  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n"
                  "  if (e != cudaSuccess) return e;\n"
                  "  return cudaMemcpyFromSymbol(rounds, g_rounds, sizeof(g_rounds));\n}\n")


def instrument_chunked(src: str) -> str:
    """The chunked kernel with a stamp at each boundary of a chunk's work."""
    src = _frame(src, "  const int nch = (T_len + C - 1) / C;\n",
                 "  for (int i = tid; i < K * VT / 4; i += NT) {\n"
                 "    const int row = i / (VT / 4), c = (i % (VT / 4)) * 4;\n"
                 "    *reinterpret_cast<float4*>(&sp[(size_t)row * K + c]) =\n"
                 "        *reinterpret_cast<const float4*>(&S[row * VS + c]);\n  }\n",
                 "tid == 0 ? 0 : (tid == 224 ? 1 : -1)")
    src = _put(src, "    __syncthreads();  // the chunk is in; the previous chunk's readers "
               "are done\n", _stamp(0) + "    ++st_rounds;\n", before=False)
    src = _put(src, "    __syncthreads();  // Rl, Kl, F, Vf and A's diagonal blocks are in",
               _stamp(1, "Rl[tid]"))
    src = _put(src, "    // ---- 2. the next chunk comes in", _stamp(2))
    src = _put(src, "    // tiles of A between sub-chunks", _stamp(3, "ysh[NH - 1][3]"))
    src = _put(src, "    __syncthreads();  // A is whole", _stamp(4, "A[tid]"))
    src = _put(src, "    // ---- 4. warp w:", _stamp(5))
    src = _put(src, "    float dsh[TPW][4], dsl[TPW][4];\n", _stamp(6, "yvh[NH - 1][3]"))
    src = _put(src, "      p1[1] = fmaf(tot1, p1[1], dsh[q][3] + dsl[q][3]);\n    }\n",
               _stamp(7, "S[m1 * VS + 8 * (n0 + TPW - 1) + 2 * t4 + 1]"), before=False)
    return src


def instrument_serial(src: str) -> str:
    """The serial kernel (one step after another) with a stamp at each
    boundary of a chunk of 16 steps and inside each step."""
    src = _frame(src, "  const int nch = (T_len + TC - 1) / TC;\n",
                 "  for (int i = 0; i < KP; ++i) sp[(size_t)(p * KP + i) * K] = S[i];\n",
                 "tid == 0 ? 0 : (tid == 1 ? 1 : -1)")
    src = _put(src, "\n    // Conversion pass", _stamp(0) + "    ++st_rounds;\n")
    src = _put(src, "    const int rowoff = p * (KP + 4);\n", _stamp(1))
    src = _put(src, "      float part = acc0 + acc1;\n",
               _stamp(2, "acc0 + acc1 + S[KP - 1]"))
    src = _put(src, "      if (p == 0) sy[t][c] = fmaf(vt, fbonus[t], part);\n",
               _stamp(3, "part"))
    src = _put(src, "      if (p == 0) sy[t][c] = fmaf(vt, fbonus[t], part);\n",
               _stamp(4), before=False)
    src = _put(src, "    T* yb = y + base + (size_t)t0 * step + v0;\n", _stamp(5))
    src = _put(src, "      store(yb + (size_t)tt * step + cc, sy[tt][cc]);\n    }\n",
               _stamp(6), before=False)
    return src


def main(argv) -> int:
    """Patch a copy of the package, then time it in a child process that
    imports the copy."""
    serial = argv[1] if len(argv) == 2 and argv[0] == "--serial" else None
    if argv and serial is None:
        print("usage: wkv6_phases [--serial PATH]", file=sys.stderr)
        return 2
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(WORK, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(WORK, "src", "repro_torch", CU)
    with open(serial or cu) as f:
        text = f.read()
    text = instrument_serial(text) if serial else instrument_chunked(text)
    with open(cu, "w") as f:
        f.write(text)
    env = dict(os.environ, PYTHONPATH=os.path.join(WORK, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.wkv6_phases",
                           "--stamped", "serial" if serial else "chunked"],
                          env=env, cwd=WORK).returncode


def stamped(form: str) -> int:
    """In the child: the stamped kernel at the served and the long shape."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build, wkv6

    if not torch.cuda.is_available():
        print("wkv6_phases: no CUDA device", file=sys.stderr)
        return 2
    _build.SIGNATURES["repro_wkv6_stamps"] = ([ctypes.c_void_p] * 2, ctypes.c_int)
    lib = _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    names = SERIAL if form == "serial" else CHUNKED
    h, kk = 64, 64
    for label, b, t in (("served_512", 1, 512), ("long_4096", 8, 4096)):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        r, k, v = randn(b, t, h, kk), randn(b, t, h, kk) * 0.3, randn(b, t, h, kk)
        w = torch.sigmoid(randn(b, t, h, kk)) * 0.5 + 0.45
        xs = [x.bfloat16() for x in (r, k, v, w, randn(h, kk) * 0.1)]
        s0 = torch.zeros(b, h, kk, kk, device=dev)
        for _ in range(5):
            wkv6(*xs, s0)
        torch.cuda.synchronize()
        stamps = np.zeros((65536, WHO, SLOTS), dtype=np.int64)
        rounds = np.zeros(65536, dtype=np.int32)
        _build.check(lib.repro_wkv6_stamps(ctypes.c_void_p(stamps.ctypes.data),
                                           ctypes.c_void_p(rounds.ctypes.data)),
                     "wkv6 stamps")
        blocks = b * h * 2 if form == "serial" else b * h * (kk // 32)
        per = stamps[:blocks] / rounds[:blocks, None, None]   # cycles per chunk
        steps = t / rounds[0]
        unit = "chunk of 16 steps" if form == "serial" else "chunk of 64 steps"
        for who in range(WHO):
            thread = (("thread 0", "thread 1") if form == "serial"
                      else ("warp 0", "warp 7"))[who]
            parts = []
            for i, name in enumerate(names):
                cyc = float(np.median(per[:, who, i]))
                if form == "serial" and name.startswith("step"):
                    parts.append(f"{name} {cyc / steps:.0f} a step")
                else:
                    parts.append(f"{name} {cyc:.0f}")
            total = float(np.median(per[:, who].sum(-1)))
            print(f"wkv6 phases {form} {label} (B={b} T={t}), {thread}, {blocks} blocks, "
                  f"{rounds[0]} chunks; median cycles a {unit}: " + "; ".join(parts)
                  + f"; chunk {total:.0f}" + (f" ({total / steps:.0f} a step)"
                                              if form == "serial" else ""))
        del r, k, v, w, xs, s0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(stamped(args[1]) if args[:1] == ["--stamped"] else main(args))
