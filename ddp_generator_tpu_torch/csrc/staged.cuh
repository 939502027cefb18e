// The producer/consumer pipeline shared by kernels B1 (backpass.cu) and B3
// (fused.cu).
//
// A block owns kLanes batch lanes.  Its warp 0 is the consumer: thread
// g < kLanes walks lane g over t = N-1 .. 0, carrying Vx/Vxx, dV, g and the
// failure flag in registers, and runs riccati.cuh's step on operands it
// reads from shared memory.  The other warps are producers: they fill a
// ring of kSlots slots, each holding one time tile (S steps x kLanes lanes)
// of every operand the consumer reads for a (t, lane) -- the derivative
// terms in the packed bundle's component order, then u (Terms below).  B1's
// producer copies the tile from the bundle with cp.async; B3's producers
// compute it (derivs.cuh, one direction pair or box-limit evaluation per
// work item).  A slot is laid out [term][step][lane], lanes fastest, so the
// consumer's reads of one term are free of bank conflicts.
//
// Why: with one thread per lane, a lane's whole work -- B3's derivative
// evaluations, B1's loads -- ran as one dependent chain on one warp per
// SM.  The TPU kernels took their parallelism from 128-lane vectors over
// each step; here the work of a step that does not depend on the carry
// runs on other warps, ahead of the one chain that does.  What is left is
// the consumer's Riccati step (~2 us on an H100) times N: B1's time at
// every width, B3's at small widths (PERF.md).  The consumer's arithmetic is
// the one-thread kernels' (fused.cuh:fused_lane, backpass.cuh:
// backpass_lane), term for term and in the same summation order, so the
// outputs are bit for bit theirs; tests/test_torch_dual_host.py holds the
// composition against those lanes on the host.
//
// Synchronisation: named barriers, two per slot.  Producers wait on slot
// r's "empty" barrier before refilling it and arrive on its "full"
// barrier when done; the consumer waits on "full", runs the tile's steps
// and arrives on "empty".  Producers thus run up to kSlots-1 tiles ahead.
#pragma once

#include "common.cuh"
#include "riccati.cuh"

namespace ddp {

// Tile constants, fixed in the source (timed on an H100 by
// scripts/tile_sweep.py; PERF.md).
constexpr int kLanes = 8;                   // lanes a block owns (G)
constexpr int kSlots = 2;                   // slots in the ring (R)
constexpr int kSlotBudget = 224 * 1024;     // bytes the ring may take

// The terms of one step in a slot: the component order of the packed
// bundle (ops/cuda_backpass.py: _BUNDLE_KEYS; cxx, cuu and the last two
// axes of fxx/fuu as row-major upper triangles), then u.
template <int NX, int NU, bool FULL>
struct Terms {
  static constexpr int TX = NX * (NX + 1) / 2, TU = NU * (NU + 1) / 2;
  static constexpr int FX = 0, FU = FX + NX * NX, CX = FU + NX * NU,
                       CU = CX + NX, CXX = CU + NU, CUU = CXX + TX,
                       CXU = CUU + TU, FXX = CXU + NX * NU,
                       FUU = FXX + (FULL ? NX * TX : 0),
                       FXU = FUU + (FULL ? NX * TU : 0),
                       LOWER = FXU + (FULL ? NX * NX * NU : 0),
                       UPPER = LOWER + NU, LO_HX = UPPER + NU,
                       UP_HX = LO_HX + NU * NX, LO_S = UP_HX + NU * NX,
                       UP_S = LO_S + NU, U = UP_S + NU, NT = U + NU;
};

// Steps per tile: 8, halved until kSlots slots fit the budget.
__host__ __device__ constexpr int fit_steps(int s, int bytes_per_step) {
  return (s == 1 || kSlots * s * bytes_per_step <= kSlotBudget)
             ? s
             : fit_steps(s / 2, bytes_per_step);
}

template <typename T, int NT>
__host__ __device__ constexpr int tile_steps() {
  return fit_steps(8, kLanes * NT * static_cast<int>(sizeof(T)));
}

// Tile j holds t = N-1 - j*S - s for s = 0 .. S-1, those >= 0.
__host__ __device__ constexpr int num_tiles(int N, int S) {
  return (N + S - 1) / S;
}
__host__ __device__ constexpr int tile_t0(int N, int S, int j) {
  return N - 1 - j * S;
}

// The consumer's share of one tile: lane b (slot column g) runs the steps
// t = t0, t0-1, ... of the tile that exist, reading each step's terms from
// the slot, and writes live * l and live * L.  The loads and the FULL_DDP
// contraction Vx . f** (summed over i = 0 .. NX-1 in index order) are
// backpass_lane's with the bundle replaced by the slot.
template <typename T, int NX, int NU, int REG, bool FULL, int S>
__host__ __device__ __forceinline__ void consume_tile(
    const T* slot, int t0, int g, int b, int B, T lam, Carry<T, NX>& c,
    T* l_out, T* L_out) {
  using K = Terms<NX, NU, FULL>;
  constexpr int TX = K::TX, TU = K::TU;
#pragma unroll 1
  for (int s = 0; s < S && t0 - s >= 0; ++s) {
    const int t = t0 - s;
    const T* q = slot + s * kLanes + g;
    auto ld = [&](int term) -> T { return q[term * S * kLanes]; };
    StepTerms<T, NX, NU> d;
    T u[NU];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      d.cx[a] = ld(K::CX + a);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        d.fx[a][e] = ld(K::FX + a * NX + e);
        d.cxx[a][e] = ld(K::CXX + tri(a, e, NX));
      }
#pragma unroll
      for (int e = 0; e < NU; ++e) {
        d.fu[a][e] = ld(K::FU + a * NU + e);
        d.cxu[a][e] = ld(K::CXU + a * NU + e);
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d.cu[a] = ld(K::CU + a);
#pragma unroll
      for (int e = 0; e < NU; ++e) d.cuu[a][e] = ld(K::CUU + tri(a, e, NU));
      d.lower[a] = ld(K::LOWER + a);
      d.upper[a] = ld(K::UPPER + a);
      d.lo_s[a] = ld(K::LO_S + a);
      d.up_s[a] = ld(K::UP_S + a);
      u[a] = ld(K::U + a);
#pragma unroll
      for (int e = 0; e < NX; ++e) {
        d.lo_hx[a][e] = ld(K::LO_HX + a * NX + e);
        d.up_hx[a][e] = ld(K::UP_HX + a * NX + e);
      }
    }
    if (FULL) {
#pragma unroll
      for (int a = 0; a < NX; ++a) {
#pragma unroll
        for (int e = 0; e < NU; ++e) {
          T s2 = c.Vx[0] * ld(K::FXU + (0 * NX + a) * NU + e);
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s2 = s2 + c.Vx[i] * ld(K::FXU + (i * NX + a) * NU + e);
          d.vfxu[a][e] = s2;
        }
#pragma unroll
        for (int e = 0; e < NX; ++e) {
          T s2 = c.Vx[0] * ld(K::FXX + 0 * TX + tri(a, e, NX));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s2 = s2 + c.Vx[i] * ld(K::FXX + i * TX + tri(a, e, NX));
          d.vfxx[a][e] = s2;
        }
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int e = 0; e < NU; ++e) {
          T s2 = c.Vx[0] * ld(K::FUU + 0 * TU + tri(a, e, NU));
#pragma unroll
          for (int i = 1; i < NX; ++i)
            s2 = s2 + c.Vx[i] * ld(K::FUU + i * TU + tri(a, e, NU));
          d.vfuu[a][e] = s2;
        }
      }
    }

    StepOut<T, NX, NU> so;
    riccati_step<T, NX, NU, REG, FULL>(d, u, lam, c.Vx, c.Vxx, so);
    const T live = advance(c, so);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      l_out[(static_cast<size_t>(t) * NU + a) * B + b] = live * so.l[a];
#pragma unroll
      for (int e = 0; e < NX; ++e)
        L_out[(static_cast<size_t>(t) * NU * NX + a * NX + e) * B + b] =
            live * so.L[a][e];
    }
  }
}

// A lane's results once its recursion has reached t = 0.
template <typename T, int NX>
__host__ __device__ __forceinline__ void finish_lane(const Carry<T, NX>& c,
                                                     int N, int B, int b,
                                                     T* dV, T* g_norm,
                                                     bool* failed) {
  dV[b] = c.dv0;
  dV[B + b] = c.dv1;
  g_norm[b] = c.g / static_cast<T>(N - 1);
  failed[b] = c.fail > T(0);
}

#ifdef __CUDACC__
// Named barriers 1 .. kSlots ("slot r full") and kSlots+1 .. 2*kSlots
// ("slot r empty"); 0 is __syncthreads'.  The non-aligned forms, so that
// a warp whose lanes diverged before may reach them.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(threads)
               : "memory");
}

// Warp 0's loop: wait until tile j's slot is full, consume it, hand the
// slot back unless no later tile will refill it.  THREADS: the block.
template <int THREADS, class Consume>
__device__ __forceinline__ void consumer_loop(int ntiles, Consume consume) {
  for (int j = 0; j < ntiles; ++j) {
    const int r = j % kSlots;
    bar_sync(1 + r, THREADS);
    consume(j, r);
    __syncwarp();
    if (j + kSlots < ntiles) bar_arrive(1 + kSlots + r, THREADS);
  }
}

// The producer warps' loop: wait until tile j's slot is free (its
// previous tile consumed), fill it, mark it full.
template <int THREADS, class Fill>
__device__ __forceinline__ void producer_loop(int ntiles, Fill fill) {
  for (int j = 0; j < ntiles; ++j) {
    const int r = j % kSlots;
    if (j >= kSlots) bar_sync(1 + kSlots + r, THREADS);
    fill(j, r);
    __threadfence_block();
    bar_arrive(1 + r, THREADS);
  }
}
#endif

}  // namespace ddp
