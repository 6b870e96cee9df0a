// The mapper's k-mer seed words on Hopper (sm_90a).
//
// Replaces racon_tpu/tpu/seedmatch.py:_builder, an XLA jax.jit kernel
// (not a Pallas one): for every k-mer start i of a flat code buffer,
//   fw[i] = codes[i .. i + k) & 3, packed big-endian (first base most
//           significant),
//   rv[i] = 3 - (codes[i .. i + k) & 3), packed little-endian (the word
//           of the reverse complement),
// k <= 15, so both fit in 30 bits.  Code 4 (a non-ACGT base) reads as
// A through the & 3, exactly as the host build does; the mapper masks
// such k-mers afterwards.
//
// What bounds it: nothing but memory.  Each base is read once and each
// k-mer start writes 8 bytes, 9 bytes a base, against a few dozen
// integer operations a k-mer: at 3.35 TB/s a 139 M-base read set takes
// ~0.37 ms.  What the design does about it:
//
// * A block stages a tile of kTile codes plus the (k - 1)-base halo in
//   shared memory, read with coalesced 16-byte loads where the tile
//   lies inside the buffer, so each base leaves device memory once
//   however many k-mers cover it.
// * Each thread then builds kPer adjacent outputs from shared memory
//   and stores them at stride blockDim.x, so a warp's stores are
//   coalesced 128-byte lines.
// * There is no padding to a bucket length (the JAX kernel pads so
//   jit retraces stay bounded); the grid covers exactly n - k + 1
//   outputs and the last tile masks its tail.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                       // outputs per thread
constexpr int kTile = kThreads * kPer;        // outputs per block
constexpr int kMaxK = 15;
constexpr int kStage = kTile + 16;            // tile + halo, 16-aligned

__global__ void __launch_bounds__(kThreads)
seed_words_kernel(const uint8_t* __restrict__ codes, long long n, int k,
                  uint32_t* __restrict__ fw, uint32_t* __restrict__ rv) {
    __shared__ __align__(16) uint8_t tile[kStage];
    const long long base = (long long)blockIdx.x * kTile;
    const long long nk = n - k + 1;
    const int need = kTile + k - 1;           // bases this block reads
    const bool aligned = ((reinterpret_cast<uintptr_t>(codes) + base) & 15)
                         == 0;
    if (aligned && base + kStage <= n) {
        const uint4* src = reinterpret_cast<const uint4*>(codes + base);
        uint4* dst = reinterpret_cast<uint4*>(tile);
        for (int i = threadIdx.x; i < kStage / 16; i += kThreads)
            dst[i] = src[i];
    } else {
        for (int i = threadIdx.x; i < need; i += kThreads) {
            const long long p = base + i;
            tile[i] = p < n ? codes[p] : 0;
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        const int i = r * kThreads + threadIdx.x;
        const long long p = base + i;
        if (p >= nk) break;
        uint32_t f = 0, b = 0;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
            if (j < k) {
                const uint32_t c = tile[i + j] & 3u;
                f = (f << 2) | c;
                b |= (3u - c) << (2 * j);
            }
        }
        fw[p] = f;
        rv[p] = b;
    }
}

}  // namespace

extern "C" {

// Builds fw / rv (n - k + 1 uint32 each) from n uint8 codes on
// ``stream``.  Returns cudaGetLastError() after the launch (0 =
// launched); an invalid k or a buffer shorter than k is refused.
int seed_words_launch(const void* codes, void* fw, void* rv, long long n,
                      int k, void* stream) {
    if (k < 1 || k > kMaxK || n < k) return (int)cudaErrorInvalidValue;
    const long long nk = n - k + 1;
    const long long grid = (nk + kTile - 1) / kTile;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    seed_words_kernel<<<(unsigned)grid, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const uint8_t*)codes, n, k, (uint32_t*)fw, (uint32_t*)rv);
    return (int)cudaGetLastError();
}

const char* seed_words_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
