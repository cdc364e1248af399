"""Where a flash-decode split block spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.launch.decode_phases

Copies the package into ``build/decode_phases/`` (git-ignored), adds
``clock64()`` stamps of thread 0 at each phase boundary of ``decode_split``
(csrc/decode_attention.cu) to the copy, and in a child process builds it
and runs the bfloat16 and the int8 kernel at the smoke's served shape (B 8,
KV 8, G 2, D 128, S 1024, a mixed index) and at S 32768 with a full cache:
the median and largest cycles of each phase over the valid blocks, and the
card's SM clock.  The stamps cost a few global stores per block; the
package's own kernel has none.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(os.path.dirname(os.path.dirname(PKG)), "build", "decode_phases")
PHASES = ["index", "q, sync", "K lands", "scores", "softmax", "V lands", "P V",
          "reduce, write"]
SLOTS = len(PHASES) + 1


def instrumented(src: str) -> str:
    """The kernel's source with a stamp at each phase boundary."""
    def put(text: str, anchor: str, stamp: str, before: bool = True) -> str:
        assert anchor in text, anchor
        return text.replace(anchor, stamp + anchor if before else anchor + stamp, 1)

    def at(k):
        return f"  if (tid == 0) g_stamp[STAMP_ROW][{k}] = clock64();\n"
    src = put(src, "namespace {\n", f"__device__ long long g_stamp[65536][{SLOTS}];\n",
              before=False)
    src = put(src, "  const int cur = min(cur_index[b], S - 1);\n",
              "  const long long stamp0 = clock64();\n")
    src = put(src, "  const int cur = min(cur_index[b], S - 1);\n",
              "  const size_t STAMP_ROW = ((size_t)blockIdx.z * gridDim.y + blockIdx.y)"
              " * gridDim.x + blockIdx.x;\n"
              "  asm volatile(\"\" :: \"r\"(cur));\n"
              "  if (tid == 0) { g_stamp[STAMP_ROW][0] = stamp0;"
              " g_stamp[STAMP_ROW][1] = clock64(); }\n", before=False)
    src = put(src, "  __syncthreads();  // the barriers are initialised, q is in place\n",
              at(2), before=False)
    src = put(src, "  mbar_wait(bar_k);\n", at(3), before=False)
    src = put(src, "  // 2. the chunk's softmax", at(4))
    src = put(src, "  // 3. acc[g][d] = sum_i", at(5))
    src = put(src, "  mbar_wait(bar_v);\n", at(6), before=False)
    src = put(src, "  // sum over the rows a warp holds", at(7))
    src = put(src, '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n',
              at(8))
    return src + ('\nextern "C" int repro_decode_stamps(void* host) {\n'
                  "  return cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n}\n")


def main() -> int:
    """Patch a copy of the package, then time it in a child process that
    imports the copy."""
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(WORK, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(WORK, "src", "repro_torch", "kernels", "decode_attention", "csrc",
                      "decode_attention.cu")
    with open(cu) as f:
        text = instrumented(f.read())
    with open(cu, "w") as f:
        f.write(text)
    env = dict(os.environ, PYTHONPATH=os.path.join(WORK, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.decode_phases",
                           "--stamped"], env=env, cwd=WORK).returncode


def stamped() -> int:
    """In the child: the stamped kernel at the served and a long shape."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as K

    if not torch.cuda.is_available():
        print("decode_phases: no CUDA device", file=sys.stderr)
        return 2
    _build.SIGNATURES["repro_decode_stamps"] = ([ctypes.c_void_p], ctypes.c_int)
    lib = _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, kv, g, d = 8, 8, 2, 128
    q = torch.randn(b, kv, g, d, generator=gen, device=dev).bfloat16()
    for s, cur in ((1024, [1023, 700, 511, 256, 255, 1, 0, 64]), (32768, [32767] * 8)):
        kc = torch.randn(b, kv, s, d, generator=gen, device=dev).bfloat16()
        vc = torch.randn(b, kv, s, d, generator=gen, device=dev).bfloat16()
        (kq, ks), (vq, vs) = (K.quantize_kv(x.transpose(1, 2)) for x in (kc, vc))
        kq, vq = kq.transpose(1, 2).contiguous(), vq.transpose(1, 2).contiguous()
        ct = torch.tensor(cur, dtype=torch.int32, device=dev)
        for label, run, elem in (
                ("bf16", lambda: K.decode_attention_grouped(q, kc, vc, ct), 2),
                ("int8", lambda: K.decode_attention_int8_grouped(q, kq, vq, ks, vs, ct), 1)):
            for _ in range(5):
                run()
            torch.cuda.synchronize()
            stamps = np.zeros((65536, SLOTS), dtype=np.int64)
            _build.check(lib.repro_decode_stamps(ctypes.c_void_p(stamps.ctypes.data)),
                         "decode stamps")
            chunk = K.chunk_len(elem, d)
            n_split = -(-s // chunk)
            rows = [(z * kv + y) * n_split + x for z in range(b) for y in range(kv)
                    for x in range(n_split) if x * chunk <= cur[z]]
            dt = np.diff(stamps[rows], axis=1)
            print(f"decode phases S={s} {label}: {len(rows)} blocks; cycles, median/max: "
                  + "; ".join(f"{name} {np.median(dt[:, i]):.0f}/{dt[:, i].max()}"
                              for i, name in enumerate(PHASES))
                  + f"; block {np.median(dt.sum(1)):.0f}/{dt.sum(1).max()}")
        del kc, vc, kq, vq, ks, vs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(stamped() if sys.argv[1:] == ["--stamped"] else main())
