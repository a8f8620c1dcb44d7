// The tiling shared by the two ballistics kernels, forward (ballistics.cu)
// and backward (ballistics_bwd.cu): each row of (R, T) is cut into tiles of
// kTile samples, one block of kThreads threads per tile, each thread owning
// a chunk of kChunk consecutive samples. At the compressor's 8 rows x
// 131072 samples that is 128 blocks; the corruption's 262144 samples give
// 256. Tiles are staged through shared memory laid out by padded(), so
// loads and stores stay coalesced and a warp reading sample k of its 32
// chunks hits 32 banks.

#pragma once

#include <cuda_runtime.h>

#include "tile_chain.cuh"

namespace dasp {
namespace ballistics {

constexpr int kChunk = 32;  // samples per thread
constexpr int kWarp = 32;
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / kWarp;
constexpr int kTile = kChunk * kThreads;  // samples per block
constexpr int kTileFloats = kTile + kTile / 32;

}  // namespace ballistics
}  // namespace dasp
