"""K1's design on the card: what held the first design back, and the
current kernel against it.

    python3 scripts/probe_k1_design.py [--reps 100]

Needs one CUDA card and nvcc; imports nothing of jax or plvs_tpu. Builds,
beside the port's ``csrc/hamming.cu``, two reference kernels from the
sources below: the first K1 design (one thread an output column, 8 POPC of
XOR an output on the CUDA cores) and a copy of it whose popcount is a
shift, which computes nothing useful and takes as long as the first design
would without its POPC issue. Then:

* ``cuobjdump -sass`` and ``-res-usage`` of each library: the tensor-core
  instructions (BMMA, IMMA, HMMA, GMMA), the POPC count, registers;
* each kernel against the plain version at phase 2's six shapes and at
  ragged and extreme ones (exact);
* device times (``chip_smoke._time_ms``: one event pair around 100 calls
  queued behind a spin kernel) at the six shapes, taken in turns (first
  design, current kernel, no-POPC copy, a ``zero_`` of the output as the
  write floor, then the reverse) and averaged; K1's device ms per 120
  RGB-D frames under phase 2's launch mix, for both designs.

``chip_smoke.py`` phase 1 times the library calls that compute the same
matrix.

Prints the card's name and power limit first and one JSON object with
every result last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from plvs_tpu_torch.ops import _build  # noqa: E402  (nothing built on import)

# phase 2's K1 launches by (Q, K) over 120 RGB-D frames (chip_smoke.py)
PHASE2_MIX = {(4096, 1024): 178, (2048, 1024): 40, (1024, 1024): 20,
              (512, 160): 19, (256, 160): 60, (128, 160): 40}

# The first K1 design, as csrc/hamming.cu held it before the tensor-core
# design, with its C entry renamed.
FIRST_DESIGN = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int WORDS = 8;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / TILE;  // 4 rows in flight per pass

__global__ void hamming_kernel(const uint32_t* __restrict__ dq,
                               const uint32_t* __restrict__ dk,
                               int32_t* __restrict__ out, int q, int k) {
  __shared__ uint32_t sq[TILE][WORDS + 1];  // +1: no bank conflicts on fill
  __shared__ uint32_t sk[TILE][WORDS + 1];
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;

  for (int i = tid; i < TILE * WORDS; i += THREADS) {
    const int r = i / WORDS, w = i % WORDS;
    sq[r][w] = (row0 + r < q) ? dq[(int64_t)(row0 + r) * WORDS + w] : 0u;
    sk[r][w] = (col0 + r < k) ? dk[(int64_t)(col0 + r) * WORDS + w] : 0u;
  }
  __syncthreads();

  const int c = tid % TILE;
  const int col = col0 + c;
  if (col >= k) return;
  uint32_t kw[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) kw[w] = sk[c][w];

  for (int r = tid / TILE; r < TILE; r += ROW_STEP) {
    const int row = row0 + r;
    if (row >= q) break;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) acc += __popc(sq[r][w] ^ kw[w]);
    out[(int64_t)row * k + col] = acc;
  }
}

}  // namespace

extern "C" int ref_hamming(const void* dq, const void* dk, void* out, int q,
                           int k, void* stream) {
  if (q <= 0 || k <= 0) return 0;
  const dim3 grid((k + TILE - 1) / TILE, (q + TILE - 1) / TILE);
  hamming_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dq), static_cast<const uint32_t*>(dk),
      static_cast<int32_t*>(out), q, k);
  return static_cast<int>(cudaGetLastError());
}
"""
POPC = "acc += __popc(sq[r][w] ^ kw[w]);"
NO_POPC = POPC.replace("__popc(sq[r][w] ^ kw[w])", "((sq[r][w] ^ kw[w]) >> 24)")
assert POPC in FIRST_DESIGN


def _build_ref(name: str, src: str) -> str:
    """Compile a reference source as the port's kernels are compiled."""
    os.makedirs(_build.BUILD, exist_ok=True)
    cu = os.path.join(_build.BUILD, f"{name}.cu")
    so = os.path.join(_build.BUILD, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    return so


TENSOR_CORE = ("BMMA", "IMMA", "HMMA", "HGMMA", "IGMMA", "BGMMA")


def _sass_summary(so: str) -> dict:
    """Tensor-core and POPC instructions in a library's SASS, and the
    registers and shared memory of each kernel."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    res = subprocess.run([tool, "-res-usage", so], capture_output=True,
                         text=True, check=True).stdout
    instrs = [m.group(1) for m in
              (re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
               for ln in sass.splitlines()) if m]
    ops = [" ".join(w for w in i.split() if not w.startswith("@"))
           for i in instrs]
    mnemonic = [o.split(" ")[0].split(".")[0] for o in ops]
    tc = [o for o, m in zip(ops, mnemonic) if m in TENSOR_CORE]
    return {"counts": {m: mnemonic.count(m) for m in (*TENSOR_CORE, "POPC")},
            "first_tensor_core_line": tc[0] if tc else None,
            "res_usage": [ln.strip() for ln in res.splitlines()
                          if "REG" in ln]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("probe_k1_design: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import _time_ms
    from plvs_tpu_torch.ops import hamming

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    _build.build_all(["hamming"])
    libs = {"first_design": _build_ref("k1_first_design", FIRST_DESIGN),
            "first_design_no_popc": _build_ref(
                "k1_no_popc", FIRST_DESIGN.replace(POPC, NO_POPC))}
    sass = {"current": _sass_summary(_build._lib_path("hamming"))}
    sass.update({n: _sass_summary(p) for n, p in libs.items()})
    for name, s in sass.items():
        print(f"sass {name}: {json.dumps(s)}")
    refs = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).ref_hamming
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        refs[name] = fn

    def ref_call(name, a, b):
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                          device=dev)
        _build.check(refs[name](a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                a.shape[0], b.shape[0], stream), name)
        return out

    rng = np.random.default_rng(0)

    def words(n, fill=None):
        a = (np.full((n, 8), fill, np.uint32) if fill is not None else
             rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
                 np.uint32))
        return torch.from_numpy(a.view(np.int32)).to(dev)

    # both designs exact against the plain version
    cases = [(q, k, words(q), words(k)) for q, k in
             list(PHASE2_MIX) + [(1, 1), (15, 7), (17, 9), (63, 65),
                                 (129, 257), (1000, 999), (4097, 1023)]]
    cases.append((300, 256, words(300, 0), words(256, 0xFFFFFFFF)))
    exact = {}
    for q, k, a, b in cases:
        ref = hamming.hamming_plain(a, b)
        exact[f"current@{q}x{k}"] = bool(torch.equal(
            hamming.hamming_matrix(a, b), ref))
        exact[f"first_design@{q}x{k}"] = bool(torch.equal(
            ref_call("first_design", a, b), ref))
    bad = [n for n, ok in exact.items() if not ok]
    print(f"exact: {len(exact) - len(bad)}/{len(exact)}; disagree: {bad}")

    # device times at the six shapes, in turns
    times: dict = {}
    for (q, k) in PHASE2_MIX:
        a, b = words(q), words(k)
        out = torch.empty((q, k), dtype=torch.int32, device=dev)
        fns = {"first_design": lambda: ref_call("first_design", a, b),
               "current": lambda: hamming.hamming_matrix(a, b),
               "first_design_no_popc":
                   lambda: ref_call("first_design_no_popc", a, b),
               "zero_": out.zero_}
        got = {n: [] for n in fns}
        for n in list(fns) + list(fns)[::-1]:
            got[n].append(_time_ms(torch, fns[n], reps=args.reps))
        times[f"{q}x{k}"] = {n: float(np.mean(v)) for n, v in got.items()}
        print(f"{q}x{k} device ms: " + ", ".join(
            f"{n} {v:.6f}" for n, v in times[f"{q}x{k}"].items()))
    per_120 = {n: sum(c * times[f"{q}x{k}"][n]
                      for (q, k), c in PHASE2_MIX.items())
               for n in ("first_design", "current")}
    print("K1 device ms per 120 RGB-D frames (phase 2 mix): "
          + json.dumps(per_120))

    result = {"card": smi, "exact_all": not bad, "sass": sass,
              "device_ms": times, "per_120_rgbd_frames_ms": per_120}
    print(json.dumps(result))
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
