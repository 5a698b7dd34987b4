// The lane layout of the fused path loop and the wavefront, built on the
// card: (px, py) of every lane and, for every pixel, the lane that renders
// it (inv), in one launch straight into device tensors.
//
// Replaces no TPU kernel: the JAX package builds these arrays in numpy on
// the host (raytracer_tpu/schedule.py:116 blocked_pixel_grid,
// raytracer_tpu/models/wavefront.py:416 _tiled_pixel_grid), and so did
// this port, which then copied them to the card from pageable memory on
// every request while the card waited (~0.1 s at 2560x1440). Those numpy
// builders stay as the reference (raytracer_tpu_torch/schedule.py); the
// wrapper is raytracer_tpu_torch/ops/cuda_lane_grid.py, whose plain
// PyTorch version computes the same closed form.
//
// One index map covers both layouts in use. Lanes run over packets of
// pkt_w x pkt_h padded-screen pixels in row-major packet order; inside a
// packet over sub-blocks of sub_w x sub_h in row-major order; inside a
// sub-block row-major. The 32x32 packets of 8x16 sub-blocks and the 8x128
// screen tiles (one sub-block a packet) are two parameter sets. A lane's
// padded position is clamped to the frame, py bottom-up. Each digit of a
// lane's index grows with its row or its column, row digits before column
// digits at every level, so a padded duplicate of a pixel (a position
// with a row or column past the frame, clamped onto it) always lies later
// in lane order than the pixel's own lane: "the first lane of a pixel
// wins" is that own lane, and inv needs no scatter.
//
// Bound: bytes. 8 bytes written a lane and 8 a pixel, nothing read: 58.98
// MB at 2560x1440, 17.6 us at 3.35 TB/s. Thread i writes lane i and pixel
// i, so every store is coalesced; the integer divisions are free beside
// the stores.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

struct Layout {
  int w, h;                  // the frame
  int pkt_w, pkt_h, pkt_n;   // a packet and its lanes
  int sub_w, sub_h, sub_n;   // a sub-block and its lanes
  int npx, nsx;              // packets a padded row, sub-blocks a packet row
};

__global__ void __launch_bounds__(BLOCK) lane_grid_kernel(Layout g, int n_lanes, int n_pix,
                                                          int* __restrict__ px,
                                                          int* __restrict__ py,
                                                          long long* __restrict__ inv) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n_lanes) {
    const int p = i / g.pkt_n, k = i - p * g.pkt_n;   // packet, lane in it
    const int s = k / g.sub_n, j = k - s * g.sub_n;   // sub-block, lane in it
    const int row = (p / g.npx) * g.pkt_h + (s / g.nsx) * g.sub_h + j / g.sub_w;
    const int col = (p % g.npx) * g.pkt_w + (s % g.nsx) * g.sub_w + j % g.sub_w;
    px[i] = min(col, g.w - 1);
    py[i] = g.h - 1 - min(row, g.h - 1);
  }
  if (i < n_pix) {
    const int r = i / g.w, c = i - r * g.w;
    const int packet = (r / g.pkt_h) * g.npx + c / g.pkt_w;
    const int sub = ((r % g.pkt_h) / g.sub_h) * g.nsx + (c % g.pkt_w) / g.sub_w;
    inv[i] = static_cast<long long>(packet) * g.pkt_n + sub * g.sub_n + (r % g.sub_h) * g.sub_w +
             c % g.sub_w;
  }
}

}  // namespace

// px, py: int32[lanes]; inv: int64[w * h], lanes = the padded frame's
// pixels. cudaErrorInvalidValue for a layout whose packets do not divide
// into sub-blocks, an empty frame, or more lanes than an int counts.
extern "C" int rt_lane_grid(int w, int h, int pkt_w, int pkt_h, int sub_w, int sub_h, int* px,
                            int* py, long long* inv, void* stream) {
  if (w < 1 || h < 1 || sub_w < 1 || sub_h < 1 || pkt_w < sub_w || pkt_h < sub_h ||
      pkt_w % sub_w || pkt_h % sub_h)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long wp = (static_cast<long long>(w) + pkt_w - 1) / pkt_w * pkt_w;
  const long long hp = (static_cast<long long>(h) + pkt_h - 1) / pkt_h * pkt_h;
  if (wp * hp > 0x7fffffffLL - BLOCK) return static_cast<int>(cudaErrorInvalidValue);
  const Layout g{w, h, pkt_w, pkt_h, pkt_w * pkt_h, sub_w, sub_h, sub_w * sub_h,
                 static_cast<int>(wp / pkt_w), pkt_w / sub_w};
  const int n_lanes = static_cast<int>(wp * hp);
  lane_grid_kernel<<<(n_lanes + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      g, n_lanes, w * h, px, py, inv);
  return static_cast<int>(cudaGetLastError());
}
