// Device stamps for tracing a solve (launches.py: stamp, read_stamps): a
// one-thread kernel that reads the device's %globaltimer (ns) when it runs
// and appends (tag, ns) to a ring.  Launched on a capturing stream it is a
// node of the graph, so it stamps every replay, inside WHILE bodies too,
// where the profiler records no kernel.
//
// The ring is an int64 tensor: ring[0] the cursor (stamps taken since the
// host last zeroed it), ring[1] the capacity C, then C slots of (tag, ns).
// Stamp i goes to slot i % C; the host decodes the order from the cursor.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* ring, long long tag) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  unsigned long long i = atomicAdd(ring, 1ull);
  unsigned long long* slot = ring + 2 + 2 * (i % ring[1]);
  slot[0] = static_cast<unsigned long long>(tag);
  slot[1] = ns;
}

}  // namespace

// ring: the device ring; tag: its index in launches.STAMP_TAGS; stream:
// the stream to stamp (the capturing one inside a capture).  Returns
// cudaGetLastError().
extern "C" int ddp_stamp(void* ring, int tag, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), tag);
  return static_cast<int>(cudaGetLastError());
}
