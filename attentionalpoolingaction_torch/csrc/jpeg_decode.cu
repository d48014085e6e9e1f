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
// their own sampling (NVJPEG_OUTPUT_YUV), and apj_ycc_to_rgb does what
// libjpeg does after its IDCT, in its integer arithmetic:
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
// against OpenCV.  It reads each chroma sample up to four times from L2
// and the luma once, and writes 3 bytes a pixel: about 5 bytes a pixel,
// bound by memory; one thread a pixel.
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

constexpr int kThreads = 256;

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

// libjpeg's upsampled chroma at output pixel (x, y) from a (ch, cw) plane
// of pitch `pitch`, subsampled by hf along x and vf along y (1 or 2).
__device__ __forceinline__ int Upsample(const uint8_t* __restrict__ c,
                                        int pitch, int cw, int ch, int hf,
                                        int vf, int x, int y) {
  const int j = x / hf, i = y / vf;
  if ((hf == 1 && vf == 1) || cw <= 2) return c[i * pitch + j];
  const int u = x & 1;
  const int j2 = u ? min(j + 1, cw - 1) : max(j - 1, 0);
  if (vf == 1) {                                   // h2v1
    return (3 * c[i * pitch + j] + c[i * pitch + j2] + (u ? 2 : 1)) >> 2;
  }
  const int v = y & 1;                             // h2v2
  const int i2 = v ? min(i + 1, ch - 1) : max(i - 1, 0);
  const int near = 3 * c[i * pitch + j] + c[i2 * pitch + j];
  const int far = 3 * c[i * pitch + j2] + c[i2 * pitch + j2];
  return (3 * near + far + (u ? 7 : 8)) >> 4;
}

__device__ __forceinline__ uint8_t Clamp(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// cw, ch: libjpeg's chroma size, ceil(w / hf) x ceil(h / vf), where the
// edges replicate (the planes may be larger; c_pitch is their row pitch).
__global__ void __launch_bounds__(kThreads)
    YccToRgbKernel(const uint8_t* __restrict__ yp, int y_pitch,
                   const uint8_t* __restrict__ cbp,
                   const uint8_t* __restrict__ crp, int c_pitch, int cw,
                   int ch, int hf, int vf, int w, int h,
                   uint8_t* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(w) * h;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       p < n; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int y = static_cast<int>(p / w), x = static_cast<int>(p % w);
    const int luma = yp[static_cast<int64_t>(y) * y_pitch + x];
    const int cb = Upsample(cbp, c_pitch, cw, ch, hf, vf, x, y) - 128;
    const int cr = Upsample(crp, c_pitch, cw, ch, hf, vf, x, y) - 128;
    // jdcolor.c's tables: FIX(1.40200) = 91881, FIX(1.77200) = 116130,
    // FIX(0.34414) = 22554, FIX(0.71414) = 46802, ONE_HALF = 32768
    uint8_t* o = out + 3 * p;
    o[0] = Clamp(luma + ((91881 * cr + 32768) >> 16));
    o[1] = Clamp(luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
    o[2] = Clamp(luma + ((116130 * cb + 32768) >> 16));
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

// libjpeg's fancy upsampling and YCbCr -> RGB of planar Y (h, w) and
// Cb, Cr (at least ceil(h / vf) x ceil(w / hf), row pitch c_pitch) into
// interleaved RGB (h, w, 3), on `stream`.
int apj_ycc_to_rgb(const unsigned char* y, int y_pitch,
                   const unsigned char* cb, const unsigned char* cr,
                   int c_pitch, int hf, int vf, int w, int h,
                   unsigned char* out, void* stream) {
  const int cw = (w + hf - 1) / hf, ch = (h + vf - 1) / vf;
  if (w <= 0 || h <= 0 || (hf != 1 && hf != 2) || (vf != 1 && vf != 2) ||
      y_pitch < w || c_pitch < cw)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(w) * h;
  const int blocks = static_cast<int>(
      (n + kThreads - 1) / kThreads < 132 * 16 ? (n + kThreads - 1) / kThreads
                                                : 132 * 16);
  YccToRgbKernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, y_pitch, cb, cr, c_pitch, cw, ch, hf, vf, w, h, out);
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
