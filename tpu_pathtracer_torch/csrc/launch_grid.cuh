// Grid sizing shared by cluster_prepass.cu (the tile_kernel spans of K5,
// K8 and K10) and closest_hit.cu (K9's shares of a tile's list): a launch
// cuts its work into a power of two of parts and takes the fewest parts
// that give the grid `aim` blocks an SM. Host code only. The build hashes
// every header of csrc/ with the source, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>

namespace {

// The current device's SM count, read once a device.
inline int sm_count() {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = sms[dev & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The fewest parts p of 1, 2, 4, .. most (a power of two) for which the
// grid of blocks(p) blocks holds aim blocks an SM; most when none does.
template <class Blocks>
int fewest_parts(int most, int aim, Blocks blocks) {
  const long long target = static_cast<long long>(aim) * sm_count();
  int parts = 1;
  while (parts < most && blocks(parts) < target) parts *= 2;
  return parts;
}

}  // namespace
