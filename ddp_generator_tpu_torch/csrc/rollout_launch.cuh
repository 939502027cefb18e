// Kernel B2: the line-search rollouts, staged for the H100: the kernel, its
// launch and its C entry points for the models a `Models` dispatcher
// instantiates (rollout.cu: the hand-written models; generated/rollout.cu:
// one model generated from a problem's torch functions, codegen.py).
//
// Replaces ddp_generator_tpu/ops/pallas_rollout.py:rollout_call
// (pl.pallas_call at line 424, body _make_rollout_kernel).  The TPU kernel
// walked time as a sequential grid with the state in VMEM scratch, took its
// parallelism from 128-lane vectors over each step, and traced the user's
// Python functions inside itself; here the model is a template parameter
// (models/*.cuh or a generated header), dispatched by name.
//
// Two modes:
//  * MULTI: the cost sweep: total cost and ok flag of every (alpha, lane),
//    no trajectories;
//  * selected: one alpha per lane; writes xs, xf, us and, with WANT_COST,
//    the total cost and ok flag.
//
// What bounds it on an H100: nothing the card counts.  The operands are
// ~16 values a step and lane (a bound of ~0.02 ms by bytes at B=2048,
// N=500), the arithmetic ~84 operations; but a trajectory is one
// dependent chain over N steps, so the chain's latency times N sets the
// time at every width.  With one thread per trajectory, a step's operand
// loads from device memory, its running cost and its stores all sat on
// that chain (1.1-1.5 us a step; the chain alone takes 0.5-0.7).  The
// design takes everything off it that the next state does not need
// (rollout.cuh):
//  * a block owns kRolloutLanes lanes; a producer warp copies each time
//    tile of xnom, unom, l and L into a shared-memory ring with cp.async,
//    a tile ahead (staged.cuh, B1's copy);
//  * the chain warps run only dx -> u -> clamp -> f, one thread per
//    trajectory, reading operands from the ring and leaving x_k, u_k in a
//    second ring;
//  * the cost warps take each finished tile from it: one work item per
//    (step, trajectory) evaluates the running cost and the finiteness
//    flags, one thread per trajectory adds them in k order, and in the
//    selected mode they write xs and us to device memory, coalesced over
//    lanes;
//  * in the sweep a block's chains are its lanes times up to kAlphaChunk
//    alphas, all reading one copy of the lane's tile.
// After the last tile the chain thread adds the final cost.
//
// Parameters: shared by every lane (LANE false: one flat array, copied to
// each thread's registers once), or per lane (LANE true: row b of a
// lane-major (B, params_ld) matrix, common.cuh's LaneRows): a chain thread
// copies its lane's row once, a cost item and the final cost read their
// chain's lane's.  The two are separate instantiations, so the shared
// launch runs the code it ran before per-lane params existed.
//
// Semantics (pallas_rollout.py:_make_rollout_kernel, ops/forward.py):
// u = u_nom + alpha*l + L*dx, exactly u_nom when alpha == 0; sequential
// clamping in constraint order, every limit from the unclamped u; the
// running cost with AL penalties; ok needs a finite cost and state at every
// step while the cost keeps accumulating; the final cost F(x_N, p, N) with
// the hfe/hfi penalties.
#pragma once

#include "common.cuh"
#include "rollout.cuh"
#include "staged.cuh"

#include <string.h>

namespace ddp {
namespace {


constexpr int kCostBarrier = 2 * kSecondRing + 1;  // among the cost warps

// Warps of a block that rolls na alphas per lane, in this order: the chain
// warps (32 trajectories each), as many cost warps, the producer warp.
__host__ __device__ constexpr int chain_warps(int na) {
  return (kRolloutLanes * na + 31) / 32;
}
__host__ __device__ constexpr int block_warps(int na) {
  return 2 * chain_warps(na) + 1;
}

// One instantiation's tile shape and its shared memory: the input ring,
// the output ring, then the cost warps' per-tile items and per-chain sums.
template <class M, typename T, bool MULTI, bool WANT_COST>
struct Shape {
  static constexpr bool COST = MULTI || WANT_COST;
  static constexpr int S = rollout_steps<M, T, MULTI>();
  static constexpr int NCH = block_chains<MULTI>();
  static constexpr int IN = RolloutTerms<M>::NT * S * kRolloutLanes;
  static constexpr int OUT = OutSlot<M, S, NCH>::SIZE;
  static constexpr int ITEMS = COST ? S * NCH : 0;
  static constexpr int kSmem =
      (kSlots * (IN + OUT) + ITEMS + NCH) * sizeof(T) + ITEMS + NCH;
  static constexpr int kMaxThreads =
      32 * block_warps(MULTI ? kAlphaChunk : 1);
};

// pp: the shared params (const T*) or the per-lane rows (LaneRows<T>).
template <class M, typename T, bool MULTI, bool WANT_COST, class PP>
__device__ __forceinline__ void rollout_block(const RolloutArgs<T>& A,
                                              PP pp) {
  using Sh = Shape<M, T, MULTI, WANT_COST>;
  constexpr int S = Sh::S, NCH = Sh::NCH, G = kRolloutLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem);
  T* out = in + kSlots * Sh::IN;
  T* cbuf = out + kSlots * Sh::OUT;
  T* c_acc = cbuf + Sh::ITEMS;
  bool* okbuf = reinterpret_cast<bool*>(c_acc + NCH);
  bool* ok_acc = okbuf + Sh::ITEMS;

  const int b0 = blockIdx.x * G, a0 = blockIdx.y * kAlphaChunk;
  const int na =
      !MULTI ? 1 : (A.A - a0 < kAlphaChunk ? A.A - a0 : kAlphaChunk);
  const int nch = G * na;
  const int cw = chain_warps(na);
  const int chain_threads = 32 * cw, cost_threads = chain_threads;
  const int in_threads = chain_threads + 32;
  const int out_threads = chain_threads + cost_threads;
  const int ntiles = num_tiles(A.N, S);
  const int warp = threadIdx.x / 32;

  for (int c = threadIdx.x; c < NCH; c += blockDim.x) {
    c_acc[c] = T(0);
    ok_acc[c] = true;
  }
  __syncthreads();

  const int c = threadIdx.x;  // a chain thread's chain
  const Chain ch = chain_of(c, b0, a0, na, A.B);
  const bool mine = warp < cw && ch.live;
  T x[M::NX];
  // a chain's lane's params (a chain past the batch's edge reads the
  // block's first lane's)
  T buf[arr(M::NP)];
  const T* p = params_for<M>(pp, mine ? ch.b : b0, buf);
  if (warp < cw) {
    T alpha = T(0);
    if (mine) {
      alpha = MULTI ? A.alpha[ch.ai] : A.alpha[ch.b];
#pragma unroll
      for (int a = 0; a < M::NX; ++a) x[a] = A.x0[a * A.B + ch.b];
    }
    consumer_loop(ntiles, in_threads, 0, [&](int j, int r) {
      ring_produce(j, out_threads, kSecondRing, [&](int, int) {
        if (mine)
          chain_tile<M, T, S, NCH>(in + r * Sh::IN, out + r * Sh::OUT,
                                   tile_len(A.N, S, j), tile_k0(S, j), ch.g,
                                   c, alpha, p, x);
        __syncwarp();
      });
    });
  } else if (warp < 2 * cw) {
    const int t = threadIdx.x - chain_threads;
    consumer_loop(ntiles, out_threads, kSecondRing, [&](int j, int r) {
      const T* o = out + r * Sh::OUT;
      const int n = tile_len(A.N, S, j), k0 = tile_k0(S, j);
      if (!MULTI) store_tile<M, T, S, NCH>(A, o, n, k0, b0, t, cost_threads);
      if (Sh::COST) {
        cost_items<M, T, S, NCH>(A, pp, o, n, k0, b0, a0, na, cbuf, okbuf,
                                 t, cost_threads);
        __syncwarp();
        bar_sync(kCostBarrier, cost_threads);
        cost_sum<T, NCH>(cbuf, okbuf, n, nch, c_acc, ok_acc, t,
                         cost_threads);
      }
    });
  } else if (warp == 2 * cw) {
    producer_loop(ntiles, in_threads, 0, [&](int j, int r) {
      rollout_fill<M, T, S>(A, tile_k0(S, j), b0, in + r * Sh::IN,
                            threadIdx.x - out_threads, 32, AsyncCopy());
      async_copies_wait();
    });
  }
  __syncthreads();  // every chain's sum is in
  if (mine)
    rollout_finish<M, T, MULTI, WANT_COST>(A, p, x, ch.b, ch.ai, c_acc[c],
                                           ok_acc[c]);
}

// LANE: per-lane params (A.params lane-major, A.params_ld a row); MULTI and
// WANT_COST stay the last two template arguments (the benchmark's trace
// reader tells the modes apart by them).
template <class M, typename T, bool LANE, bool MULTI, bool WANT_COST>
__global__ void __launch_bounds__(Shape<M, T, MULTI, WANT_COST>::kMaxThreads,
                                  1)
    rollout_kernel(const RolloutArgs<T> A) {
  if (rollout_skipped(A)) return;  // the whole block: before any barrier
  if constexpr (LANE) {
    rollout_block<M, T, MULTI, WANT_COST>(A,
                                          LaneRows<T>{A.params, A.params_ld});
  } else {
    with_params<M>(A.params, [&](const T* p) {
      rollout_block<M, T, MULTI, WANT_COST>(A, p);
    });
  }
}

// One instantiation: its launch and its attributes.
template <class M, typename T, bool LANE, bool MULTI, bool WANT_COST>
struct Variant {
  using Model = M;
  using Sh = Shape<M, T, MULTI, WANT_COST>;

  static int launch(const RolloutArgs<T>& a, cudaStream_t stream) {
    const auto kernel = rollout_kernel<M, T, LANE, MULTI, WANT_COST>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int na = !MULTI ? 1 : (a.A < kAlphaChunk ? a.A : kAlphaChunk);
    const dim3 grid(grid_for(a.B, kRolloutLanes),
                    MULTI ? grid_for(a.A, kAlphaChunk) : 1);
    kernel<<<grid, 32 * block_warps(na), Sh::kSmem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  static int info(int* out) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(
        &fa, rollout_kernel<M, T, LANE, MULTI, WANT_COST>);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int v[6] = {kRolloutLanes, Sh::S, Sh::kMaxThreads / 32, Sh::kSmem,
                      fa.numRegs, static_cast<int>(fa.localSizeBytes)};
    for (int i = 0; i < 6; ++i) out[i] = v[i];
    return 0;
  }
};

// f(Variant<...>()) for model M in the given mode.
template <class M, typename T, bool LANE, class F>
int modes(bool multi, bool want_cost, F f) {
  if (multi) return f(Variant<M, T, LANE, true, true>());
  if (want_cost) return f(Variant<M, T, LANE, false, true>());
  return f(Variant<M, T, LANE, false, false>());
}

// f(Variant<...>()) for the instantiated model, params and mode:
// Models::with(name, g) calls g(M()) for the model of that name and
// returns kBadVariant for any other.
template <typename T, class Models, class F>
int visit(const char* model, bool lane, bool multi, bool want_cost, F f) {
  return Models::with(model, [&](auto m) -> int {
    using M = decltype(m);
    return lane ? modes<M, T, true>(multi, want_cost, f)
                : modes<M, T, false>(multi, want_cost, f);
  });
}

// ld: 0 for shared params, else the row length of per-lane ones.
template <typename T, class Models>
int launch(const char* model, bool multi, bool want_cost, int N, int B,
           int A, long long ld, void* const* p, cudaStream_t stream) {
  RolloutArgs<T> a;
  auto in = [&](int i) { return static_cast<const T*>(p[i]); };
  auto out = [&](int i) { return static_cast<T*>(p[i]); };
  a.xnom = in(0); a.unom = in(1); a.l = in(2); a.L = in(3);
  a.mu_le = in(4); a.mu_li = in(5); a.x0 = in(6); a.wpl = in(7);
  a.wpf = in(8); a.mu_fe = in(9); a.mu_fi = in(10); a.alpha = in(11);
  a.params = in(12);
  a.cost = out(13);
  a.ok = static_cast<bool*>(p[14]);
  a.xs = out(15); a.xf = out(16); a.us = out(17);
  a.run = static_cast<const int*>(p[18]);
  a.N = N;
  a.B = B;
  a.A = A;
  a.params_ld = ld;
  for (int i : {0, 1, 2, 3, 6, 7, 8, 11, 12})
    if (p[i] == nullptr) return kNullPointer;
  if ((multi || want_cost) && (!a.cost || !a.ok)) return kNullPointer;
  if (!multi && (!a.xs || !a.xf || !a.us)) return kNullPointer;
  return visit<T, Models>(model, ld > 0, multi, want_cost, [&](auto v) {
    using M = typename decltype(v)::Model;
    const bool need_al = (M::NHLE && !a.mu_le) || (M::NHLI && !a.mu_li) ||
                         (M::NHFE && !a.mu_fe) || (M::NHFI && !a.mu_fi);
    return need_al ? static_cast<int>(kNullPointer)
                   : decltype(v)::launch(a, stream);
  });
}

// The bodies of the C entry points (see rollout.cu for their contract);
// ld: 0 for shared params, else the row length of per-lane ones.
template <class Models>
int rollout_entry(int dtype, const char* model, int multi, int want_cost,
                  int N, int B, int A, int block, long long ld,
                  void* const* ptrs, void* stream) {
  if (N < 1 || B < 1 || A < 1 || block < 1 || block > 1024 || ld < 0)
    return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, Models>(model, multi != 0, want_cost != 0, N, B, A,
                                 ld, ptrs, s);
  if (dtype == 1)
    return launch<double, Models>(model, multi != 0, want_cost != 0, N, B, A,
                                  ld, ptrs, s);
  return kBadDtype;
}

// The shared-params instantiation's.
template <class Models>
int rollout_info_entry(int dtype, const char* model, int multi,
                       int want_cost, int* out) {
  auto info = [&](auto v) { return decltype(v)::info(out); };
  const bool m = multi != 0, c = want_cost != 0;
  if (dtype == 0) return visit<float, Models>(model, false, m, c, info);
  if (dtype == 1) return visit<double, Models>(model, false, m, c, info);
  return kBadDtype;
}

}  // namespace
}  // namespace ddp
