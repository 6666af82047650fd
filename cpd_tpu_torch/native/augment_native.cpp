// Fused data-augmentation executor of the PyTorch port, its own copy of
// cpd_tpu/native/augment_native.cpp: the Crop -> FlipLR -> Cutout recipe
// of cpd_tpu_torch/data/augment.py (the DavidNet pipeline of the
// reference's example/DavidNet/utils.py:89-145) in one host pass.
//
// One pass per output pixel: gather from the reflect-padded normalized
// dataset at the sample's pre-drawn crop offset, horizontally mirrored
// when the flip choice is set, zeroed inside the cutout box (cutout
// coordinates are in post-flip output frame, matching the numpy order
// crop -> flip -> cutout).  The batch is split across std::thread
// workers (the numpy path is single-threaded gather chains).
//
// Bit-exactness contract: pure copies and zero-writes of fp32 values, no
// arithmetic, so results are bitwise the numpy path's
// (tests/test_torch_native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// in:       (n_total, ih, iw, ch) fp32, C-contiguous (padded dataset)
// indices:  (b,) int64 rows of `in` to augment
// crop_y/x: (n_total,) int64 per-DATASET-sample crop origins
// flip:     (n_total,) uint8 booleans
// cut_y/x:  (n_total,) int64 cutout origins in output coords (ignored
//           when cut_h == 0)
// out:      (b, oh, ow, ch) fp32
void cpd_fused_augment(const float* in, const int64_t* indices, int64_t b,
                       int64_t ih, int64_t iw, int64_t ch,
                       const int64_t* crop_y, const int64_t* crop_x,
                       int64_t oh, int64_t ow,
                       const uint8_t* flip,
                       const int64_t* cut_y, const int64_t* cut_x,
                       int64_t cut_h, int64_t cut_w,
                       float* out, int64_t n_threads) {
  const int64_t in_row = iw * ch;
  const int64_t in_img = ih * in_row;
  const int64_t out_row = ow * ch;
  const int64_t out_img = oh * out_row;

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t src_idx = indices[i];
      const float* src = in + src_idx * in_img;
      float* dst = out + i * out_img;
      const int64_t y0 = crop_y[src_idx];
      const int64_t x0 = crop_x[src_idx];
      const bool fl = flip[src_idx] != 0;
      const int64_t cy = cut_h ? cut_y[src_idx] : -1;
      const int64_t cx = cut_h ? cut_x[src_idx] : -1;
      for (int64_t oy = 0; oy < oh; ++oy) {
        const float* srow = src + (y0 + oy) * in_row + x0 * ch;
        float* drow = dst + oy * out_row;
        if (!fl) {
          std::memcpy(drow, srow, out_row * sizeof(float));
        } else {
          for (int64_t ox = 0; ox < ow; ++ox)
            std::memcpy(drow + ox * ch, srow + (ow - 1 - ox) * ch,
                        ch * sizeof(float));
        }
        if (cut_h && oy >= cy && oy < cy + cut_h) {
          const int64_t lo_x = std::max<int64_t>(cx, 0);
          const int64_t hi_x = std::min<int64_t>(cx + cut_w, ow);
          if (hi_x > lo_x)
            std::memset(drow + lo_x * ch, 0, (hi_x - lo_x) * ch
                        * sizeof(float));
        }
      }
    }
  };

  int64_t workers = std::min<int64_t>(
      n_threads > 0 ? n_threads
                    : (int64_t)std::thread::hardware_concurrency(),
      b);
  if (workers <= 1) {
    work(0, b);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (b + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    const int64_t lo = w * chunk;
    const int64_t hi = std::min(lo + chunk, b);
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
