"""Where a step of the one-thread-per-trajectory rollout (kernel B2's
reference, ``rollout.cuh: rollout_lane``) spends its time, on one CUDA
card.

    python3 scripts/rollout_step_split.py [--widths 2048,128] [--reps 20]
        [--out build/rollout_split/split.json]

Builds, only for this measurement, variants of the one-thread rollout on
CarParking in float32, 64 threads a block, and times each (CUDA events) in
both modes (the 8-alpha cost sweep; the selected rollout with cost) on the
operands of ``chip_smoke.py`` phase 4 (the initial rollout of ``bench.py``'s
inputs, N=500, gains from the backward pass's plain version):

* ``base``: ``rollout_lane`` as it is: operands from device memory, the
  running cost and the stores of xs/us on the trajectory's thread;
* ``global_nocost``: the same without the running cost and its sum;
* ``shared``: operands read from a shared-memory tile that the block loads
  16 steps at a time with ``cp.async`` (all loads of a tile in flight at
  once, but not overlapped with the steps), the rest as ``base``;
* ``shared_nocost``: the tile, no running cost;
* ``chain``: the tile, no running cost, no stores of xs/us: only
  dx -> u -> clamp -> f, the floor of one thread per trajectory;
* ``f_only``: the tile, x_{k+1} = f(x_k, u_nom_k): the dynamics alone.

The variants without cost write a checksum of the final state instead, so
the chain stays live.  ``base`` is checked against the package's plain
version.  The SASS of every variant goes to ``--sass`` with a summary per
kernel: instructions, local-memory loads and stores (LDL/STL), calls and
special-function instructions.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ddp_generator_tpu_torch import _build  # noqa: E402

VARIANTS = ("base", "global_nocost", "shared", "shared_nocost", "chain",
            "f_only")

SOURCE = r"""
#include "models/car_parking.cuh"
#include "rollout.cuh"

using namespace ddp;
using M = CarParking;
constexpr int kBlock = 64, kSteps = 16;
constexpr int NX = M::NX, NU = M::NU, NT = RolloutTerms<M>::NT;

template <typename T>
__device__ __forceinline__ const T* term_src(const RolloutArgs<T>& A,
                                             int term, int k, int b) {
  using K = RolloutTerms<M>;
  const size_t kb = static_cast<size_t>(k);
  if (term < K::UNOM) return A.xnom + (kb * NX + term) * A.B + b;
  if (term < K::LFF) return A.unom + (kb * NU + term - K::UNOM) * A.B + b;
  if (term < K::LFB) return A.l + (kb * NU + term - K::LFF) * A.B + b;
  return A.L + (kb * NU * NX + term - K::LFB) * A.B + b;
}

template <typename T, bool MULTI, bool SHARED, bool COST, bool STORE,
          bool FONLY>
__global__ void variant_kernel(const RolloutArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [term][step][thread]
  const int tid = threadIdx.x;
  const int idx = blockIdx.x * kBlock + tid;
  const int N = A.N, B = A.B;
  T p[M::NP];
#pragma unroll
  for (int i = 0; i < M::NP; ++i) p[i] = A.params[i];
  const int ai = MULTI ? idx / B : 0;
  const int b = idx - ai * B;
  const T alpha = MULTI ? A.alpha[ai] : A.alpha[b];
  T x[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) x[a] = A.x0[a * B + b];
  T c_acc = T(0);
  bool ok = true;
  for (int k0 = 0; k0 < N; k0 += kSteps) {
    const int n = N - k0 < kSteps ? N - k0 : kSteps;
    if (SHARED) {
      // the block copies the tile with 16-byte cp.async (a plain load and
      // store per value would serialise: the compiler cannot tell the
      // tile from the operands' memory)
      __syncthreads();
      constexpr int CH = kBlock / 4;  // 16-byte chunks per (term, step)
      for (int i = tid; i < NT * n * CH; i += kBlock) {
        const int row = i / CH, ch = i - row * CH;
        const int term = row / n, s = row - term * n;
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
            tile + (term * kSteps + s) * kBlock + ch * 4));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(term_src(A, term, k0 + s, b - tid + ch * 4))
                     : "memory");
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    for (int s = 0; s < n; ++s) {
      const int k = k0 + s;
      using K = RolloutTerms<M>;
      auto ld = [&](int t) -> T {
        return SHARED ? tile[(t * kSteps + s) * kBlock + tid]
                      : *term_src(A, t, k, b);
      };
      StepOperands<M, T> o;
#pragma unroll
      for (int a = 0; a < NX; ++a) o.xnom[a] = ld(K::XNOM + a);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        o.unom[j] = ld(K::UNOM + j);
        o.l[j] = ld(K::LFF + j);
#pragma unroll
        for (int a = 0; a < NX; ++a)
          o.L[j * NX + a] = ld(K::LFB + j * NX + a);
      }
      T u[NU], xn[NX];
      if (FONLY) {
#pragma unroll
        for (int j = 0; j < NU; ++j) u[j] = o.unom[j];
      } else {
        control_step<M>(x, o, alpha, p, k, u);
      }
      M::f(x, u, p, k, xn);
      if (COST) {
        T c;
        const bool ok_k = step_cost<M>(A, p, k, b, x, u, xn, &c);
        c_acc = c_acc + c;
        ok = ok && ok_k;
      }
      if (STORE && !MULTI) {
        const size_t kb = static_cast<size_t>(k);
#pragma unroll
        for (int a = 0; a < NX; ++a) A.xs[(kb * NX + a) * B + b] = x[a];
#pragma unroll
        for (int j = 0; j < NU; ++j) A.us[(kb * NU + j) * B + b] = u[j];
      }
#pragma unroll
      for (int a = 0; a < NX; ++a) x[a] = xn[a];
    }
  }
  if (COST) {
    rollout_finish<M, T, MULTI, true>(A, p, x, b, ai, c_acc, ok);
  } else {
    A.cost[ai * B + b] = ((x[0] + x[1]) + x[2]) + x[3];
    A.ok[ai * B + b] = true;
  }
}

template <typename T, bool MULTI>
__global__ void base_kernel(const RolloutArgs<T> A) {
  const int idx = blockIdx.x * kBlock + threadIdx.x;
  T p[M::NP];
#pragma unroll
  for (int i = 0; i < M::NP; ++i) p[i] = A.params[i];
  rollout_lane<M, T, MULTI, true>(A, p, idx);
}

template <bool MULTI>
static int run(int variant, const RolloutArgs<float>& a, cudaStream_t st) {
  const long long total = MULTI ? static_cast<long long>(a.A) * a.B : a.B;
  if (a.B % kBlock) return -1;
  const unsigned grid = static_cast<unsigned>(total / kBlock);
  const int smem = NT * kSteps * kBlock * sizeof(float);
#define LAUNCH(SH, CO, STO, FO)                                          \
  {                                                                      \
    auto kern = variant_kernel<float, MULTI, SH, CO, STO, FO>;           \
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                         smem);                                          \
    kern<<<grid, kBlock, SH ? smem : 0, st>>>(a);                        \
  }
  switch (variant) {
    case 0: base_kernel<float, MULTI><<<grid, kBlock, 0, st>>>(a); break;
    case 1: LAUNCH(false, false, true, false) break;
    case 2: LAUNCH(true, true, true, false) break;
    case 3: LAUNCH(true, false, true, false) break;
    case 4: LAUNCH(true, false, false, false) break;
    case 5: LAUNCH(true, false, false, true) break;
    default: return -2;
  }
  return static_cast<int>(cudaGetLastError());
}

// ptrs as ddp_rollout's.
extern "C" int split_run(int variant, int multi, int N, int B, int A,
                         void* const* p, void* stream) {
  RolloutArgs<float> a;
  auto in = [&](int i) { return static_cast<const float*>(p[i]); };
  auto out = [&](int i) { return static_cast<float*>(p[i]); };
  a.xnom = in(0); a.unom = in(1); a.l = in(2); a.L = in(3);
  a.mu_le = in(4); a.mu_li = in(5); a.x0 = in(6); a.wpl = in(7);
  a.wpf = in(8); a.mu_fe = in(9); a.mu_fi = in(10); a.alpha = in(11);
  a.params = in(12);
  a.cost = out(13);
  a.ok = static_cast<bool*>(p[14]);
  a.xs = out(15); a.xf = out(16); a.us = out(17);
  a.run = nullptr;
  a.N = N; a.B = B; a.A = A;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return multi ? run<true>(variant, a, st) : run<false>(variant, a, st);
}
"""


def build_variants() -> Path:
    """nvcc the measurement source with the package's flags; the library."""
    out_dir = _build.BUILD_ROOT.parent / "rollout_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "split.cu", out_dir / "libsplit.so"
    src.write_text(SOURCE)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-shared", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise _build.KernelCompileError(proc.stdout + proc.stderr)
    (out_dir / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    return lib


def sass_summary(lib: Path, sass_out: Path) -> dict:
    """cuobjdump -sass of the library to ``sass_out``; per kernel the
    counts of instructions, LDL/STL, CALL, MUFU, LDG, STG, LDS."""
    exe = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    sass_out.parent.mkdir(parents=True, exist_ok=True)
    sass_out.write_text(text)
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = dict(instructions=0, LDL=0, STL=0, CALL=0, MUFU=0,
                             LDG=0, STG=0, LDS=0, BRA=0)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)",
                     ln)
        if m and name:
            out[name]["instructions"] += 1
            op = m.group(1).split(".")[0]
            if op in out[name]:
                out[name][op] += 1
    return out


def operands(B: int):
    """``ddp_rollout``'s operand list at width B, float32, as phase 4 of
    ``chip_smoke.py`` builds it (gains from B1's plain version)."""
    import numpy as np
    import torch

    import ddp_generator_tpu_torch as ddp
    from ddp_generator_tpu_torch.models import car_parking
    from ddp_generator_tpu_torch.ops import cuda_backpass as cb
    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    problem = car_parking.car_parking()
    dev = torch.device("cuda")
    p, r, m, w, sd, fcx, fcxx, us_cm, _ = cs.nominal_bundle(
        problem, B, cs.T_MAIN, torch.float32, dev)
    rng = np.random.default_rng(0)
    lam_np = 10.0 ** rng.uniform(-6, 2, size=B)
    lam_np[::4] = -1.0
    lam = torch.as_tensor(lam_np, dtype=torch.float32, device=dev)[None]
    bp = cb.back_pass_cm_plain(sd, fcx, fcxx, us_cm, lam, problem.n_x, 1,
                               True)
    N = cs.T_MAIN
    l_b = bp[0].permute(2, 0, 1)
    L_b = bp[1].permute(2, 0, 1).reshape(B, N, problem.n_u, problem.n_x)
    ctx = cr._LSCtx(problem, r.xs[:, 0], r.xs, r.us, l_b, L_b, None, None,
                    m.mu_le, m.mu_li, m.mu_fe, m.mu_fi, w, w)
    alphas = tuple(ddp.SolverOptions().alpha)
    alpha_vec = torch.as_tensor(
        np.random.default_rng(1).choice(alphas, B), dtype=torch.float32,
        device=dev)[None].contiguous()
    p_flat = problem.cuda_model.flat_params(p, torch.float32, dev, N)
    return problem, alphas, ctx, alpha_vec, p, p_flat


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="2048,128")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="build/rollout_split/split.json")
    ap.add_argument("--sass", default="build/rollout_split/split.sass")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ddp_generator_tpu_torch.ops import cuda_rollout as cr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    path = build_variants()
    lib = ctypes.CDLL(str(path))
    i, vp = ctypes.c_int, ctypes.c_void_p
    lib.split_run.argtypes = [i, i, i, i, i, ctypes.POINTER(vp), vp]
    for ln in (path.parent / "ptxas.txt").read_text().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print("[ptxas]", ln.strip())
    results = {"card": smi, "times_ms": {}}
    for B in map(int, args.widths.split(",")):
        problem, alphas, ctx, alpha_vec, p, p_flat = operands(B)
        N, A = cs.T_MAIN, len(alphas)
        dev = alpha_vec.device
        for multi in (True, False):
            alpha_t = (torch.tensor(alphas, dtype=torch.float32, device=dev)
                       if multi else alpha_vec)
            shape = (A, B) if multi else (1, B)
            cost = torch.empty(shape, dtype=torch.float32, device=dev)
            ok = torch.empty(shape, dtype=torch.bool, device=dev)
            xs = torch.empty((N, 4, B), dtype=torch.float32, device=dev)
            xf = torch.empty((4, B), dtype=torch.float32, device=dev)
            us = torch.empty((N, 2, B), dtype=torch.float32, device=dev)
            ptrs = _build.pointer_array([
                ctx.xnom_cm, ctx.unom_cm, ctx.l_cm, ctx.L_cm, None, None,
                ctx.x0_cm, ctx.wpl, ctx.wpf, None, None, alpha_t, p_flat,
                cost, ok, xs, xf, us])
            stream = torch.cuda.current_stream().cuda_stream
            mode = "multi" if multi else "selected"
            for v, name in enumerate(VARIANTS):
                def fn(v=v):
                    rc = lib.split_run(v, int(multi), N, B, A, ptrs, stream)
                    if rc != 0:
                        raise RuntimeError(f"variant {name}: code {rc}")
                ms = cs.time_ms(fn, args.reps)
                if name == "base":  # the reference must be the plain version
                    ref = cr.rollout_plain(
                        problem, alphas, ctx.xnom_cm, ctx.unom_cm, ctx.l_cm,
                        ctx.L_cm, ctx.mu_le_cm, ctx.mu_li_cm, ctx.x0_cm,
                        ctx.wpl, ctx.wpf, ctx.mu_fe_cm, ctx.mu_fi_cm,
                        None if multi else alpha_vec, p, multi=multi,
                        want_cost=True)
                    ref_cost = ref[0] if multi else ref[3]
                    err = cs.max_rel_err(cost, ref_cost)[1]
                    print(f"[split] base {mode} B={B} rel_err_vs_plain={err}",
                          flush=True)
                key = f"{name} {mode} B={B}"
                results["times_ms"][key] = ms
                print(f"[split] {key} ms={ms:.4f} "
                      f"us_per_step={1e3 * ms / N:.4f}", flush=True)
    results["sass"] = sass_summary(path, Path(args.sass))
    for name, d in results["sass"].items():
        print("[sass]", name[:60], d)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
