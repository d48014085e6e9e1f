// JPEG decode on the card: nvJPEG's entropy decode and IDCT, then a
// hand-written kernel for libjpeg's chroma upsampling and colour
// conversion.  Plain C interface for ctypes
// (attentionalpoolingaction_torch/data/jpeg.py).
//
// The JAX package decodes on the host with cv2.imdecode
// (data/preprocessing_np.py:17-23), which is libjpeg-turbo, outside any
// Pallas kernel.  nvJPEG's own RGB output upsamples the chroma of 4:2:0
// and 4:2:2 streams by replication, where libjpeg's default ("fancy")
// upsampling interpolates, and rounds its colour conversion otherwise: on
// MPII-sized 4:2:0 images that put 1-2% of pixels more than 8 levels from
// OpenCV's.  So a colour stream is decoded into planar Y, Cb and Cr at
// their own sampling (NVJPEG_OUTPUT_YUV), and apj_ycc_to_rgb_batch does
// what libjpeg does after its IDCT, in its integer arithmetic:
//
//   * h2v1 (4:2:2) and h2v2 (4:2:0) fancy upsampling, jdsample.c: each
//     output sample weighs its nearer chroma sample 3/4 and the farther one
//     1/4 along each subsampled axis, with libjpeg's biases (8 and 7 over
//     16 for h2v2, 1 and 2 over 4 for h2v1) and the edges replicated;
//     replication when the chroma is 2 samples wide or less, as libjpeg;
//   * YCbCr -> RGB, jdcolor.c: 16-bit fixed point, R = Y + round(1.402
//     Cr'), B = Y + round(1.772 Cb'), G = Y + floor((-0.34414 Cb' -
//     0.71414 Cr') 2^16 + 2^15) / 2^16, clamped to 0..255.
//
// The kernel is held bit for bit against its plain version in torch ops
// (data/jpeg.py::ycc_to_rgb_plain), which the CPU tests hold bit for bit
// against OpenCV.  What bounds it on the H100: bytes (the planes read
// once, 3 bytes a pixel written once: ~4.5 bytes a pixel at 4:2:0, ~66 MB
// and 0.0198 ms for 16 MPII-size 1280x720 images), with ~30 integer
// operations a pixel not far below that on the CUDA cores.  The first
// design (one thread a pixel, a 64-bit / and % a pixel, three byte stores
// at a stride of 3, each chroma sample read up to four times from L2, one
// launch an image) took 0.0128 ms an image against a bound of 0.0012 ms
// (9.4%), below the ~0.005 ms that a launch costs the timer.  So the
// kernel now converts every colour image of a decode() call in one launch:
//
//   * apj_ycc_to_rgb_batch takes a device table (packed in Python,
//     data/jpeg.py::ycc_batch_plan) of one descriptor an image (plane
//     pointers, pitches, sizes, sampling), so images of any size and
//     sampling share a launch, and one tile a block: an image and a run of
//     its 16-pixel groups, and the chroma rows those pixels need.  A block
//     finds its image and tile by one table read, without a division.
//   * A block stages its chroma rows (each with the one neighbouring row a
//     side that h2v2 needs) from global memory into shared memory once.
//   * A thread converts 16 pixels at a time: pixel group k covers the
//     image's bytes [48 k, 48 k + 48) of interleaved RGB, three aligned
//     16-byte stores whatever the width (an (h, w, 3) output of w = 517
//     has rows of 1551 bytes); only the image's last, partial group is
//     written byte by byte.  Where the 16 pixels lie in one row, the luma
//     comes in one 16-byte load and each chroma plane as a window of 10
//     columns (h2v1, h2v2) whose column sums serve all 16; a group that
//     crosses a row end takes the per-pixel path.  The 48 output bytes are
//     packed by one byte permute a word.
//
// nvJPEG: one image a call with nvjpegDecode (the default backend:
// Huffman decoding on the host thread, the IDCT on the card), into
// buffers the caller allocated (torch tensors), on the caller's stream.
// One handle and one decode state per host thread, made at the thread's
// first call and kept for the life of the process: a caller that decodes
// on many short-lived threads should decode on a bounded pool instead
// (serve_cli does); apj_decoder_count says how many were made.  The host stage of a
// decode writes the state's buffers, which the card's stage of the last
// decode may not have read yet: its copy waits in stream order behind
// whatever the stream holds (a forward of the eval loop, say), and
// nvjpegDecode returns before it.  So each decode records an event on its
// stream, and the next decode with the state first waits for it (on any
// stream).  Batched decode and the hardware engine
// (NVJPEG_BACKEND_HARDWARE) are speed work for later.
//
// Return codes: 0, an nvjpegStatus_t (> 0) or -(cudaError_t) (< 0);
// apj_error_string gives the text.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  // recorded after the last decode with the state, on its stream; the
  // next decode waits for it before the state's buffers are written again
  cudaEvent_t done = nullptr;
  bool used = false;
};

thread_local Decoder tls_decoder;
// nvJPEG handles made in this process, one a thread that decoded
std::atomic<int> decoders_made{0};

int GetDecoder(Decoder** out) {
  Decoder& d = tls_decoder;
  if (d.handle == nullptr) {
    nvjpegStatus_t st = nvjpegCreateSimple(&d.handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      d.handle = nullptr;
      return static_cast<int>(st);
    }
    decoders_made.fetch_add(1);
  }
  if (d.state == nullptr) {
    nvjpegStatus_t st = nvjpegJpegStateCreate(d.handle, &d.state);
    if (st != NVJPEG_STATUS_SUCCESS) {
      d.state = nullptr;
      return static_cast<int>(st);
    }
  }
  if (d.done == nullptr) {
    cudaError_t e = cudaEventCreateWithFlags(&d.done, cudaEventDisableTiming);
    if (e != cudaSuccess) {
      d.done = nullptr;
      return -static_cast<int>(e);
    }
  }
  *out = &d;
  return 0;
}

constexpr int kYccThreads = 256;
constexpr int kDescWords = 12;  // int64 words a descriptor (data/jpeg.py)
constexpr int kTileWords = 5;   // int32 words a tile
constexpr int kGroup = 16;      // pixels a thread converts at once
constexpr int kMaxSmem = 232448;

// A descriptor: y, cb, cr, out (pointers), y_pitch, c_pitch, w, h, hf, vf,
// cw, ch; cw x ch is libjpeg's chroma size, ceil(w / hf) x ceil(h / vf),
// where the edges replicate (the planes may be larger).  A tile: image,
// first and end group (k_lo, k_hi), first staged chroma row and rows.
struct Image {
  const uint8_t* y;
  const uint8_t* cb;
  const uint8_t* cr;
  uint8_t* out;
  int y_pitch, c_pitch, w, h, hf, vf, cw, ch;
};

__host__ __device__ inline Image ReadImage(const long long* d) {
  Image m;
  m.y = reinterpret_cast<const uint8_t*>(d[0]);
  m.cb = reinterpret_cast<const uint8_t*>(d[1]);
  m.cr = reinterpret_cast<const uint8_t*>(d[2]);
  m.out = reinterpret_cast<uint8_t*>(d[3]);
  m.y_pitch = static_cast<int>(d[4]);
  m.c_pitch = static_cast<int>(d[5]);
  m.w = static_cast<int>(d[6]);
  m.h = static_cast<int>(d[7]);
  m.hf = static_cast<int>(d[8]);
  m.vf = static_cast<int>(d[9]);
  m.cw = static_cast<int>(d[10]);
  m.ch = static_cast<int>(d[11]);
  return m;
}

// The output rows [ra, rb] that groups [k_lo, k_hi) of an image touch, and
// the chroma rows [c_lo, c_hi] their upsampling reads (ycc_batch_plan's
// rule, checked here on the host).
inline void TileRows(const Image& m, long long k_lo, long long k_hi,
                     long long* c_lo, long long* c_hi) {
  const long long hw = static_cast<long long>(m.w) * m.h;
  const long long ra = kGroup * k_lo / m.w;
  const long long rb = (k_hi * kGroup < hw ? k_hi * kGroup : hw) - 1;
  const long long rbr = rb / m.w;
  if (m.vf == 2) {
    *c_lo = ra / 2 - 1 > 0 ? ra / 2 - 1 : 0;
    *c_hi = rbr / 2 + 1 < m.ch - 1 ? rbr / 2 + 1 : m.ch - 1;
  } else {
    *c_lo = ra;
    *c_hi = rbr;
  }
}

__device__ __forceinline__ int Clamp255(int v) { return min(max(v, 0), 255); }

// jdcolor.c's fixed point, 0x00BBGGRR: FIX(1.40200) = 91881, FIX(1.77200) =
// 116130, FIX(0.34414) = 22554, FIX(0.71414) = 46802, ONE_HALF = 32768.
__device__ __forceinline__ uint32_t Rgb(int luma, int cb, int cr) {
  cb -= 128;
  cr -= 128;
  const int r = Clamp255(luma + ((91881 * cr + 32768) >> 16));
  const int g = Clamp255(luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  const int b = Clamp255(luma + ((116130 * cb + 32768) >> 16));
  return static_cast<uint32_t>(r) | (static_cast<uint32_t>(g) << 8) |
         (static_cast<uint32_t>(b) << 16);
}

// libjpeg's upsampled chroma at output pixel (x, y), from the staged chroma
// rows c (row stride cw, first row c_lo): h2v1 and h2v2 fancy upsampling,
// jdsample.c; replication where the chroma is 2 samples wide or less.
__device__ __forceinline__ int Upsample(const uint8_t* c, int cw, int ch,
                                        int c_lo, int hf, int vf, int x,
                                        int y) {
  const int j = hf == 2 ? x >> 1 : x, i = vf == 2 ? y >> 1 : y;
  const uint8_t* r1 = c + (i - c_lo) * cw;
  if (hf == 1 || cw <= 2) return r1[j];
  const int u = x & 1;
  const int j2 = u ? min(j + 1, cw - 1) : max(j - 1, 0);
  if (vf == 1) return (3 * r1[j] + r1[j2] + (u ? 2 : 1)) >> 2;
  const int i2 = (y & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
  const uint8_t* r2 = c + (i2 - c_lo) * cw;
  const int near = 3 * r1[j] + r2[j];
  const int far = 3 * r1[j2] + r2[j2];
  return (3 * near + far + (u ? 7 : 8)) >> 4;
}

// The h2 outputs of pixels x0 .. x0 + 15, x0 = A mod 2, from the column
// sums col[m] of chroma column (x0 >> 1) - 1 + m (edges replicated):
// pixel k takes column 1 + ((A + k) >> 1) and its neighbour on the side
// of its parity.
template <int A, int VF>
__device__ __forceinline__ void H2Outputs(const int* col, int* out) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int m = 1 + ((A + k) >> 1);
    const int u = (A + k) & 1;
    const int other = u ? col[m + 1] : col[m - 1];
    out[k] = VF == 2 ? (3 * col[m] + other + (u ? 7 : 8)) >> 4
                     : (3 * col[m] + other + (u ? 2 : 1)) >> 2;
  }
}

// The upsampled chroma of the 16 pixels x0 .. x0 + 15 of output row y, all
// inside the row (so cw > 2 where HF = 2).
template <int HF, int VF>
__device__ __forceinline__ void Chroma16(const uint8_t* c, int cw, int ch,
                                         int c_lo, int x0, int y, int* out) {
  if (HF == 1) {
    const uint8_t* r1 = c + (y - c_lo) * cw + x0;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) out[k] = r1[k];
    return;
  }
  const int i = VF == 2 ? y >> 1 : y;
  const uint8_t* r1 = c + (i - c_lo) * cw;
  const uint8_t* r2 = r1;
  if (VF == 2) {
    const int i2 = (y & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
    r2 = c + (i2 - c_lo) * cw;
  }
  const int jb = (x0 >> 1) - 1;
  int col[10];
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    const int j = min(max(jb + m, 0), cw - 1);
    col[m] = VF == 2 ? 3 * r1[j] + r2[j] : r1[j];
  }
  if (x0 & 1) {
    H2Outputs<1, VF>(col, out);
  } else {
    H2Outputs<0, VF>(col, out);
  }
}

template <int HF, int VF>
__device__ __forceinline__ void Group16(const Image& m, const uint8_t* cbs,
                                        const uint8_t* crs, int c_lo, bool flat,
                                        unsigned q0, int x0, int y,
                                        uint32_t* px) {
  int cb[kGroup], cr[kGroup];
  Chroma16<HF, VF>(cbs, m.cw, m.ch, c_lo, x0, y, cb);
  Chroma16<HF, VF>(crs, m.cw, m.ch, c_lo, x0, y, cr);
  int luma[kGroup];
  if (flat) {  // the 16 pixels are 16 aligned bytes of the plane
    const uint4 v = *reinterpret_cast<const uint4*>(m.y + q0);
    const uint32_t wl[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < kGroup; ++k) luma[k] = (wl[k >> 2] >> (8 * (k & 3))) & 0xff;
  } else {
    const uint8_t* yr = m.y + static_cast<size_t>(y) * m.y_pitch + x0;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) luma[k] = yr[k];
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) px[k] = Rgb(luma[k], cb[k], cr[k]);
}

// Grid: one block a tile of `tiles` (after the n descriptors of `desc`).
// Four blocks an SM (64 registers a thread, no spills): on 16 MPII-size
// images on an H100 that took the launch from 0.0457 ms at three blocks
// (80 registers) to 0.0392 ms; five spilled and ran slower.
__global__ void __launch_bounds__(kYccThreads, 4)
    YccToRgbBatchKernel(const long long* __restrict__ desc,
                        const int* __restrict__ tiles) {
  extern __shared__ __align__(16) uint8_t stage[];
  const int* t = tiles + kTileWords * blockIdx.x;
  const int k_lo = t[1], k_hi = t[2], c_lo = t[3], c_rows = t[4];
  const Image m = ReadImage(desc + kDescWords * t[0]);
  const int tid = threadIdx.x;

  // The tile's chroma rows, from global memory once: words where the rows
  // allow, else bytes.
  uint8_t* cbs = stage;
  uint8_t* crs = stage + c_rows * m.cw;
  const bool words =
      ((m.c_pitch | m.cw) & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(m.cb) | reinterpret_cast<uintptr_t>(m.cr)) &
       3) == 0;
  for (int r = 0; r < c_rows; ++r) {
    const size_t src = static_cast<size_t>(c_lo + r) * m.c_pitch;
    if (words) {
      const uint32_t* b4 = reinterpret_cast<const uint32_t*>(m.cb + src);
      const uint32_t* r4 = reinterpret_cast<const uint32_t*>(m.cr + src);
      uint32_t* bd = reinterpret_cast<uint32_t*>(cbs + r * m.cw);
      uint32_t* rd = reinterpret_cast<uint32_t*>(crs + r * m.cw);
      for (int j = tid; j < m.cw / 4; j += kYccThreads) {
        bd[j] = b4[j];
        rd[j] = r4[j];
      }
    } else {
      for (int j = tid; j < m.cw; j += kYccThreads) {
        cbs[r * m.cw + j] = m.cb[src + j];
        crs[r * m.cw + j] = m.cr[src + j];
      }
    }
  }
  __syncthreads();

  const bool flat =
      m.y_pitch == m.w && (reinterpret_cast<uintptr_t>(m.y) & 15) == 0;
  const unsigned w = m.w;
  const unsigned hw = w * static_cast<unsigned>(m.h);
  const int mode = m.hf == 1 ? 0 : m.vf == 1 ? 1 : 2;
  for (int k = k_lo + tid; k < k_hi; k += kYccThreads) {
    const unsigned q0 = kGroup * static_cast<unsigned>(k);
    const unsigned y0 = q0 / w;
    const int x0 = static_cast<int>(q0 - y0 * w);
    const bool whole = q0 + kGroup <= hw;
    uint32_t px[kGroup];
    if (whole && x0 + kGroup <= m.w) {
      if (mode == 0) {
        Group16<1, 1>(m, cbs, crs, c_lo, flat, q0, x0, y0, px);
      } else if (mode == 1) {
        Group16<2, 1>(m, cbs, crs, c_lo, flat, q0, x0, y0, px);
      } else {
        Group16<2, 2>(m, cbs, crs, c_lo, flat, q0, x0, y0, px);
      }
    } else {  // across a row end, or the image's last group
      int x = x0, y = static_cast<int>(y0);
#pragma unroll
      for (int kk = 0; kk < kGroup; ++kk) {
        px[kk] = 0;
        if (q0 + kk < hw) {
          const int luma = m.y[static_cast<size_t>(y) * m.y_pitch + x];
          px[kk] = Rgb(luma, Upsample(cbs, m.cw, m.ch, c_lo, m.hf, m.vf, x, y),
                       Upsample(crs, m.cw, m.ch, c_lo, m.hf, m.vf, x, y));
          if (++x == m.w) {
            x = 0;
            ++y;
          }
        }
      }
    }
    uint8_t* o = m.out + 3 * static_cast<size_t>(q0);
    if (whole) {  // bytes [48 k, 48 k + 48): three aligned 16-byte stores
      // word i holds bytes 4 i .. 4 i + 3 of the group, from pixels
      // 4 i / 3 and the next: one byte permute a word
      uint32_t wd[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int p0 = 4 * i / 3;
        unsigned sel = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int byte = 4 * i + b;
          sel |= static_cast<unsigned>((byte / 3 == p0 ? 0 : 4) + byte % 3)
                 << (4 * b);
        }
        wd[i] = __byte_perm(px[p0], px[p0 + 1], sel);
      }
      uint4* o4 = reinterpret_cast<uint4*>(o);
      o4[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      o4[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
      o4[2] = make_uint4(wd[8], wd[9], wd[10], wd[11]);
    } else {  // the image's last group: its pixels byte by byte
#pragma unroll
      for (int kk = 0; kk < kGroup; ++kk) {
        if (q0 + kk < hw) {
          o[3 * kk] = px[kk] & 0xff;
          o[3 * kk + 1] = (px[kk] >> 8) & 0xff;
          o[3 * kk + 2] = (px[kk] >> 16) & 0xff;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Components, chroma subsampling (nvjpegChromaSubsampling_t), the image's
// size and the size of its second component (the chroma planes) of one
// JPEG stream.
int apj_image_info(const unsigned char* data, size_t length, int* components,
                   int* subsampling, int* width, int* height,
                   int* chroma_width, int* chroma_height) {
  Decoder* d = nullptr;
  int err = GetDecoder(&d);
  if (err) return err;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  nvjpegStatus_t st = nvjpegGetImageInfo(d->handle, data, length, components,
                                         &css, widths, heights);
  *subsampling = static_cast<int>(css);
  *width = widths[0];
  *height = heights[0];
  *chroma_width = widths[1];
  *chroma_height = heights[1];
  return static_cast<int>(st);
}

// Decode one JPEG stream on `stream`: with `gray`, the luma plane alone
// into y (pitch y_pitch); else planar Y, Cb and Cr at their own sampling
// into y, cb and cr (the chroma planes of pitch c_pitch).
int apj_decode(const unsigned char* data, size_t length, int gray,
               unsigned char* y, int y_pitch, unsigned char* cb,
               unsigned char* cr, int c_pitch, void* stream) {
  Decoder* d = nullptr;
  int err = GetDecoder(&d);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d->used) {
    cudaError_t e = cudaEventSynchronize(d->done);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  nvjpegImage_t image = {};
  image.channel[0] = y;
  image.pitch[0] = static_cast<size_t>(y_pitch);
  if (!gray) {
    image.channel[1] = cb;
    image.pitch[1] = static_cast<size_t>(c_pitch);
    image.channel[2] = cr;
    image.pitch[2] = static_cast<size_t>(c_pitch);
  }
  nvjpegStatus_t st = nvjpegDecode(
      d->handle, d->state, data, length,
      gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &image, s);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  cudaError_t e = cudaEventRecord(d->done, s);
  if (e != cudaSuccess) return -static_cast<int>(e);
  d->used = true;
  return 0;
}

// libjpeg's fancy upsampling and YCbCr -> RGB of every image of a batch in
// one launch on `stream`.  `host` and `device` hold the same table (data/
// jpeg.py::ycc_batch_plan): n_images descriptors of kDescWords int64 words,
// then n_tiles tiles of kTileWords int32 words.  The host copy is checked
// here (sizes, sampling, pitches, 16-byte aligned outputs, tiles that cover
// each image's groups once, in order, with the chroma rows they read, in
// `smem` bytes); the kernel reads the device copy.
int apj_ycc_to_rgb_batch(const long long* host, const long long* device,
                         int n_images, int n_tiles, long long smem,
                         void* stream) {
  const int bad = -static_cast<int>(cudaErrorInvalidValue);
  if (n_images < 1 || n_tiles < 1 || smem < 16 || smem > kMaxSmem ||
      smem % 16 != 0)
    return bad;
  for (int i = 0; i < n_images; ++i) {
    const Image m = ReadImage(host + kDescWords * i);
    if (m.w <= 0 || m.h <= 0 || !m.y || !m.cb || !m.cr || !m.out ||
        (reinterpret_cast<uintptr_t>(m.out) & 15) != 0 ||
        !((m.hf == 1 && m.vf == 1) || (m.hf == 2 && (m.vf == 1 || m.vf == 2))) ||
        m.cw != (m.w + m.hf - 1) / m.hf || m.ch != (m.h + m.vf - 1) / m.vf ||
        m.y_pitch < m.w || m.c_pitch < m.cw ||
        static_cast<long long>(m.w) * m.h >= (1LL << 31))
      return bad;
  }
  const int* tiles = reinterpret_cast<const int*>(host + kDescWords * n_images);
  int image = 0;
  long long next = 0;  // the next group of `image` that no tile holds yet
  for (int t = 0; t < n_tiles; ++t) {
    const int* tl = tiles + kTileWords * t;
    if (tl[0] != image) {  // the last image is whole; the next one starts
      const Image m = ReadImage(host + kDescWords * image);
      if (tl[0] != image + 1 ||
          next != (static_cast<long long>(m.w) * m.h + kGroup - 1) / kGroup)
        return bad;
      image = tl[0];
      next = 0;
    }
    const Image m = ReadImage(host + kDescWords * image);
    long long c_lo = 0, c_hi = 0;
    if (tl[1] != next || tl[2] <= tl[1]) return bad;
    TileRows(m, tl[1], tl[2], &c_lo, &c_hi);
    if (tl[3] < 0 || tl[4] < 1 || tl[3] > c_lo || tl[3] + tl[4] - 1 < c_hi ||
        tl[3] + tl[4] > m.ch || 2LL * tl[4] * m.cw > smem)
      return bad;
    next = tl[2];
  }
  {
    const Image m = ReadImage(host + kDescWords * image);
    if (image != n_images - 1 ||
        next != (static_cast<long long>(m.w) * m.h + kGroup - 1) / kGroup)
      return bad;
  }
  cudaError_t e = cudaFuncSetAttribute(
      YccToRgbBatchKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  YccToRgbBatchKernel<<<n_tiles, kYccThreads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      device, reinterpret_cast<const int*>(device + kDescWords * n_images));
  return -static_cast<int>(cudaGetLastError());
}

// The number of nvJPEG decoders (handle and state, one a host thread) made
// in this process; none is freed before the process exits.
int apj_decoder_count() { return decoders_made.load(); }

const char* apj_error_string(int code) {
  if (code < 0) return cudaGetErrorString(static_cast<cudaError_t>(-code));
  switch (code) {
    case 0: return "success";
    case 1: return "NVJPEG_STATUS_NOT_INITIALIZED";
    case 2: return "NVJPEG_STATUS_INVALID_PARAMETER";
    case 3: return "NVJPEG_STATUS_BAD_JPEG";
    case 4: return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
    case 5: return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
    case 6: return "NVJPEG_STATUS_EXECUTION_FAILED";
    case 7: return "NVJPEG_STATUS_ARCH_MISMATCH";
    case 8: return "NVJPEG_STATUS_INTERNAL_ERROR";
    case 9: return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
    default: return "unknown nvJPEG status";
  }
}

}  // extern "C"
