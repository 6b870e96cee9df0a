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
// k-mer start writes 8 bytes, 9 bytes a base, against a few integer
// operations a k-mer: at 3.35 TB/s a 139 M-base read set takes ~0.37
// ms.  What the design does about it:
//
// * One block a tile of kTile words; the block scheduler hands the
//   card's SMs the next tile as a block ends.  (A persistent grid of
//   one to four waves of resident blocks, walking the tiles by a grid
//   stride with the next tile's load in flight, ran slower on an H100
//   in an A/B on the card, at every grid size tried.)
// * The tile and its (k - 1)-base halo come into shared memory by
//   16-byte cp.async from the aligned chunks that cover them, so any
//   offset of ``codes`` is taken and each base leaves device memory once.
// * Each thread builds runs of kRun = 4 adjacent words by rolling one
//   k-mer into the next (f = (f << 2 | c) & mask, b = b >> 2 | (3 - c) <<
//   2 (k - 1)) after a (k - 1)-base warm-up, the runs of a warp side by
//   side: one 16-byte store a thread and plane covers 512 contiguous
//   bytes a warp, whole 32-byte sectors.  (Runs of 16 words a thread,
//   64 bytes apart across a warp, wrote half sectors a store and ran
//   far slower on an H100.)
// * The stores carry the streaming hint (__stcs): the words go straight
//   back to the host, so they need not stay in L2.  A run that crosses
//   the end of the buffer stores word by word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;                       // words a run
constexpr int kRuns = 4;                      // runs a thread
constexpr int kTile = kThreads * kRun * kRuns;  // words a block
constexpr int kMaxK = 15;
// a tile's bases with the halo and the alignment slack, 16-byte chunks
constexpr int kChunks = (kTile + kMaxK - 1 + 15) / 16 + 1;

__global__ void __launch_bounds__(kThreads)
seed_words_kernel(const uint8_t* __restrict__ codes, long long n, int k,
                  uint32_t* __restrict__ fw, uint32_t* __restrict__ rv) {
    __shared__ __align__(16) uint8_t stage[kChunks * 16];
    const long long nk = n - k + 1;
    const long long base = (long long)blockIdx.x * kTile;
    // the aligned chunks that cover bases [base, base + kTile + k - 1);
    // chunks wholly past the buffer's end are zero-filled (src-size 0),
    // so no read leaves the aligned chunks that hold the buffer's bytes
    const uintptr_t first = reinterpret_cast<uintptr_t>(codes + base) & ~15ull;
    const uintptr_t end = reinterpret_cast<uintptr_t>(codes + n);
    for (int m = threadIdx.x; m < kChunks; m += kThreads) {
        const uintptr_t src = first + 16ull * m;
        const unsigned dst = (unsigned)__cvta_generic_to_shared(stage + 16 * m);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     ::"r"(dst), "l"(src < end ? src : first),
                       "r"(src < end ? 16 : 0) : "memory");
    }
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" ::: "memory");
    __syncthreads();
    const uint32_t mask = (1u << (2 * k)) - 1u;
    const int back = 2 * (k - 1);
    const uint8_t* tile = stage + (reinterpret_cast<uintptr_t>(codes) & 15);
#pragma unroll
    for (int run = 0; run < kRuns; ++run) {
        const int lp = (run * kThreads + threadIdx.x) * kRun;
        const long long p0 = base + lp;
        if (p0 >= nk) break;
        const uint8_t* s = tile + lp;
        // warm-up: the first k - 1 bases of the run's first k-mer
        uint32_t f = 0, b = 0;
        for (int m = 0; m < k - 1; ++m) {
            const uint32_t c = s[m] & 3u;
            f = (f << 2) | c;
            b = (b >> 2) | ((3u - c) << back);
        }
        uint32_t wf[kRun], wr[kRun];
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
            const uint32_t c = s[k - 1 + m] & 3u;
            f = ((f << 2) | c) & mask;
            b = (b >> 2) | ((3u - c) << back);
            wf[m] = f;
            wr[m] = b;
        }
        if (p0 + kRun <= nk) {
            __stcs(reinterpret_cast<uint4*>(fw + p0),
                   make_uint4(wf[0], wf[1], wf[2], wf[3]));
            __stcs(reinterpret_cast<uint4*>(rv + p0),
                   make_uint4(wr[0], wr[1], wr[2], wr[3]));
        } else {
#pragma unroll
            for (int m = 0; m < kRun; ++m) {
                if (p0 + m < nk) {
                    __stcs(fw + p0 + m, wf[m]);
                    __stcs(rv + p0 + m, wr[m]);
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// Loads the kernel on the current device.  CUDA loads a module at its
// first use, so a launch that came first would pay for the load inside
// its dispatch's event window; seed_words_buffers calls this
// before the window.  Returns a CUDA error code (0 = ready).
int seed_words_prepare() {
    cudaFuncAttributes a;
    return (int)cudaFuncGetAttributes(&a, seed_words_kernel);
}

// Builds fw / rv (n - k + 1 uint32 each, 16-byte aligned) from n uint8
// codes on ``stream``, one block a tile.  Returns cudaGetLastError()
// after the launch (0 = launched); an invalid k, a buffer shorter than k
// or unaligned outputs are refused.
int seed_words_launch(const void* codes, void* fw, void* rv, long long n,
                      int k, void* stream) {
    if (k < 1 || k > kMaxK || n < k) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(fw) | reinterpret_cast<uintptr_t>(rv))
        & 15)
        return (int)cudaErrorMisalignedAddress;
    const long long grid = (n - k + 1 + kTile - 1) / kTile;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    seed_words_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, n, k, (uint32_t*)fw, (uint32_t*)rv);
    return (int)cudaGetLastError();
}

const char* seed_words_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
