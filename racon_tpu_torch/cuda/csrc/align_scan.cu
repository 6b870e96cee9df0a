// The scan align ladder's two kernels on Hopper (sm_90a).
//
// Replace racon_tpu/tpu/aligner.py:_align_kernel (:75) and
// _banded_align_kernel (:166), XLA jax.jit kernels (not Pallas ones):
// unit-cost global alignment of a batch of pairs, swept over the
// anti-diagonals d = 1 .. ql + tl of the DP, cell (i, j) = (d - j, j):
//
//   cur = min(diag + (q[i-1] != t[j-1]), up + 1, left + 1),
//   boundary cells (i == 0 or j == 0) = d,
//   direction 0 (diagonal) if cur == diag candidate, else 1 (up) if
//   cur == up candidate, else 2 (left),
//
// then a traceback from (ql, tl) that writes the reversed op tape
// (= 1, X 2, I 3, D 4; 0 after (0, 0)).  Query codes past lq read QPAD
// (5), target codes past lt TPAD (6); neither matches anything, while N
// (4) matches N.
//
// Full kernel: columns 0..lt of each diagonal.  Only cells with i <= ql
// and j <= tl are computed: the traceback reads no other cell, and none
// of those reads another.
//
// Banded kernel (half-width hw): the wb = hw + 2 slots of diagonal d
// start at column jlo(d) = max(0, floor((d - hw + 1) / 2)).  Slot s
// reads up and left at slots s + d1 and s + d1 - 1 of diagonal d - 1
// and diag at slot s + d2 - 1 of d - 2, where d1, d2 (0 or 1) are jlo's
// advances; slots past the band read BIG.  Cells off the padded matrix
// (j > lt, i > lq or i < 0) are BIG, every other value is clipped to
// BIG, and the direction is taken from the clipped value.  The
// traceback reads slot clip(j - jlo(d), 0, wb - 1), so a lane whose path
// leaves the band reads edge slots: every slot of every diagonal it
// reaches is computed exactly as the JAX kernel computes it, and a lane
// past its band gives the JAX kernel's tape too.
//
// Design (one pair per block, a simple right design first):
//
// * The three rolling diagonals (d, d - 1, d - 2) are int32 rows of
//   W + 2 words in shared memory (W = wb slots with a BIG word at each
//   end, or lt + 1 columns), opted in above 48 KB; past the block's
//   shared memory they live in a per-block slice of device scratch.
//   The pair's two sequences are staged beside them as bytes when they
//   fit.  Diagonal d writes row d % 3 and reads the other two, so one
//   barrier a diagonal orders everything.
// * Thread k takes slots (columns) k, k + T, ...: consecutive threads
//   read consecutive words.  Four lanes' 2-bit directions meet by two
//   xor shuffles into one byte (cell c at byte c >> 2, bits 2 (c & 3),
//   the JAX kernel's layout), so a warp writes 8 consecutive bytes of
//   the lane's direction row of diagonal d (ceil(W / 4) bytes a row,
//   (lq + lt) rows a lane in device memory).
// * Traceback: the block stages windows of up to 32 direction rows
//   into the (now free) rolling rows, with coalesced loads, and thread
//   0 walks them; the op tape was zeroed by the caller, so only the
//   path's ops are written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr uint8_t kQPad = 5, kTPad = 6;
constexpr int kDirDiag = 0, kDirUp = 1, kDirLeft = 2;
constexpr uint8_t kOpEq = 1, kOpX = 2, kOpI = 3, kOpD = 4;
constexpr int kMaxThreads = 1024;
constexpr int kWindowRows = 32;

// floor(x / 2) for any sign (C's / truncates)
__device__ __forceinline__ int floor_half(int x) {
    return (x - (x < 0 && (x & 1))) / 2;
}

__device__ __forceinline__ int jlo_of(int d, int hw) {
    return max(0, floor_half(d - hw + 1));
}

// one byte of four lanes' 2-bit codes, written by the group's first
// lane (every lane of the warp calls this)
__device__ __forceinline__ void pack_store(uint8_t* row, int cell, int code,
                                           int pw) {
    unsigned x = (unsigned)code << (2 * (threadIdx.x & 3));
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
    if ((threadIdx.x & 3) == 0 && (cell >> 2) < pw)
        row[cell >> 2] = (uint8_t)x;
}

template <bool kBanded>
__global__ void __launch_bounds__(kMaxThreads, 1)
align_scan_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ t, const int* __restrict__ ql,
                  const int* __restrict__ tl, uint8_t* __restrict__ dirs,
                  uint8_t* __restrict__ ops, int* __restrict__ roll_g,
                  int lq, int lt, int hw, int roll_smem, int seq_smem) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_state[3];            // traceback i, j, tape position
    const int lane = blockIdx.x;
    const int QL = min(max(ql[lane], 0), lq);
    const int TL = min(max(tl[lane], 0), lt);
    const int D = QL + TL;
    if (D == 0) return;
    const int tid = threadIdx.x, T = blockDim.x;
    const int W = kBanded ? hw + 2 : lt + 1;
    const int RW = W + 2;
    const int PW = (W + 3) / 4;
    int* roll = roll_smem ? reinterpret_cast<int*>(smem)
                          : roll_g + (size_t)lane * 3 * RW;
    const uint8_t* qs = q + (size_t)lane * lq;
    const uint8_t* ts = t + (size_t)lane * lt;
    if (seq_smem) {
        uint8_t* sq = smem + (size_t)12 * RW;
        uint8_t* st = sq + lq;
        for (int k = tid; k < lq; k += T) sq[k] = qs[k];
        for (int k = tid; k < lt; k += T) st[k] = ts[k];
        qs = sq;
        ts = st;
    }
    for (int k = tid; k < 3 * RW; k += T) roll[k] = kBig;
    __syncthreads();
    // diagonal 0 (row 0): cell (0, 0) = 0, at slot 0 (word 1) or column 0
    if (tid == 0) roll[kBanded ? 1 : 0] = 0;
    __syncthreads();
    uint8_t* drow = dirs + (size_t)lane * (lq + lt) * PW;

    for (int d = 1; d <= D; ++d) {
        int* cur = roll + (d % 3) * RW;
        const int* p1 = roll + ((d + 2) % 3) * RW;
        const int* p2 = roll + ((d + 1) % 3) * RW;
        uint8_t* row = drow + (size_t)(d - 1) * PW;
        if (kBanded) {
            const int lo = jlo_of(d, hw);
            const int d1 = lo - jlo_of(d - 1, hw);
            const int d2 = lo - jlo_of(d - 2, hw);
            for (int base = 0; base + (tid & ~31) < W; base += T) {
                const int s = base + tid;
                int code = 0;
                if (s < W) {
                    const int up = p1[s + d1 + 1];
                    const int left = p1[s + d1];
                    const int dg = p2[s + d2];
                    const int j = lo + s, i = d - j;
                    const uint8_t qc = (i >= 1 && i <= lq) ? qs[i - 1] : kQPad;
                    const uint8_t tc = (j >= 1 && j <= lt) ? ts[j - 1] : kTPad;
                    const int cd = dg + (qc != tc);
                    const int cu = up + 1;
                    int v = min(min(cd, cu), left + 1);
                    if (j == 0 || i == 0) v = d;
                    v = (j > lt || i > lq || i < 0) ? kBig : min(v, kBig);
                    code = v == cd ? kDirDiag : (v == cu ? kDirUp : kDirLeft);
                    cur[s + 1] = v;
                }
                pack_store(row, s, code, PW);
            }
        } else {
            const int jmin = max(0, d - QL), jmax = min(d, TL);
            for (int base = jmin & ~31; base + (tid & ~31) <= jmax;
                 base += T) {
                const int j = base + tid;
                int code = 0;
                if (j >= jmin && j <= jmax) {
                    const int i = d - j;
                    int v = d;
                    if (i != 0 && j != 0) {
                        const int cd = p2[j - 1] + (qs[i - 1] != ts[j - 1]);
                        const int cu = p1[j] + 1;
                        v = min(min(cd, cu), p1[j - 1] + 1);
                        code = v == cd ? kDirDiag
                                       : (v == cu ? kDirUp : kDirLeft);
                    }
                    cur[j] = v;
                }
                pack_store(row, j, code, PW);
            }
        }
        __syncthreads();
    }

    // traceback over staged windows of direction rows
    uint8_t* win = reinterpret_cast<uint8_t*>(roll);
    const int rows = min(kWindowRows, 12 * RW / PW);
    uint8_t* tape = ops + (size_t)lane * (lq + lt);
    if (tid == 0) {
        s_state[0] = QL;
        s_state[1] = TL;
        s_state[2] = 0;
    }
    __syncthreads();
    while (true) {
        int i = s_state[0], j = s_state[1];
        const int d = i + j;
        if (d == 0) break;
        const int dlo = max(1, d - rows + 1);
        const uint8_t* src = drow + (size_t)(dlo - 1) * PW;
        const int n = (d - dlo + 1) * PW;
        for (int k = tid; k < n; k += T) win[k] = src[k];
        __syncthreads();
        if (tid == 0) {
            int pos = s_state[2];
            while ((i > 0 || j > 0) && i + j >= dlo) {
                const int dd = i + j;
                const int s = kBanded
                    ? min(max(j - jlo_of(dd, hw), 0), W - 1) : j;
                int code = (win[(dd - dlo) * PW + (s >> 2)] >> (2 * (s & 3)))
                           & 3;
                if (i == 0) code = kDirLeft;
                if (j == 0) code = kDirUp;
                uint8_t op;
                if (code == kDirDiag) {
                    op = qs[i - 1] == ts[j - 1] ? kOpEq : kOpX;
                    --i;
                    --j;
                } else if (code == kDirUp) {
                    op = kOpI;
                    --i;
                } else {
                    op = kOpD;
                    --j;
                }
                tape[pos++] = op;
            }
            s_state[0] = i;
            s_state[1] = j;
            s_state[2] = pos;
        }
        __syncthreads();
    }
}

// shared memory of one block, and whether the rolling rows and the
// sequences fit there
struct Layout {
    int threads, smem, roll_smem, seq_smem;
    long long roll_bytes;     // one block's rolling rows
};

Layout layout(int lq, int lt, int hw) {
    int dev = 0, optin = 48 << 10;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    optin -= 64;                           // the static s_state words
    const long long w = hw ? (long long)hw + 2 : (long long)lt + 1;
    Layout l;
    l.roll_bytes = 12 * (w + 2);
    l.roll_smem = l.roll_bytes <= optin;
    l.seq_smem = l.roll_smem && l.roll_bytes + lq + lt <= optin;
    l.smem = (int)((l.roll_smem ? l.roll_bytes : 0)
                   + (l.seq_smem ? lq + lt : 0));
    l.threads = (int)(w < kMaxThreads ? (w + 31) / 32 * 32 : kMaxThreads);
    return l;
}

}  // namespace

extern "C" {

// Device scratch bytes one lane needs for its rolling rows (0 when they
// fit in shared memory).
long long align_scan_roll_bytes(int lq, int lt, int hw) {
    const Layout l = layout(lq, lt, hw);
    return l.roll_smem ? 0 : l.roll_bytes;
}

// Aligns b pairs on ``stream``: q [b, lq], t [b, lt] uint8 codes, ql, tl
// [b] int32, hw 0 for the full kernel, else the band's half-width.
// dirs holds b * (lq + lt) * ceil(W / 4) bytes (W = hw + 2, or lt + 1),
// ops [b, lq + lt] uint8 zeroed, roll b * align_scan_roll_bytes() bytes
// (unused when that is 0).  Returns cudaGetLastError() after the launch
// (0 = launched).
int align_scan_launch(const void* q, const void* t, const void* ql,
                      const void* tl, void* dirs, void* ops, void* roll,
                      int b, int lq, int lt, int hw, void* stream) {
    if (b < 0 || lq < 1 || lt < 1 || hw < 0)
        return (int)cudaErrorInvalidValue;
    if (b == 0) return 0;
    const Layout l = layout(lq, lt, hw);
    if (!l.roll_smem && roll == nullptr) return (int)cudaErrorInvalidValue;
    auto kernel = hw ? align_scan_kernel<true> : align_scan_kernel<false>;
    if (l.smem > (48 << 10)) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<b, l.threads, l.smem, (cudaStream_t)stream>>>(
        (const uint8_t*)q, (const uint8_t*)t, (const int*)ql,
        (const int*)tl, (uint8_t*)dirs, (uint8_t*)ops, (int*)roll, lq, lt,
        hw, l.roll_smem, l.seq_smem);
    return (int)cudaGetLastError();
}

const char* align_scan_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
