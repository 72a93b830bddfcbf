// lmono_tpu native runtime: threaded KITTI scan loader, range-image
// regridding, and binary PLY export.
//
// TPU-native counterpart of the reference's C++ host runtime: the rosbag →
// MeasurementManager ingestion path (mono_lidar_mapping/src/image_process/
// MeasurementManager.cc — std::queue + mutex/condvar pairing loop) becomes a
// threaded prefetching frame loader; PCL's PLY writer (Map_Builder.cc:90-94)
// becomes a direct binary writer.  Exposed with a plain C ABI for ctypes;
// the JAX side consumes fixed-shape (rings, W) arrays straight from here.
//
// Build: make -C native  (produces libmono_native.so)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct GridCfg {
  int rings;
  int width;
  float vfov_lo_deg;
  float vfov_hi_deg;
  float min_range;
  float max_range;
  int ring_mode;  // 0=uniform elevation, 1=hdl64 two-block, 2=auto
                  // (scan-order recovery, hdl64 fallback; needs rings==64)
};

// HDL-64E S2 two-block vertical layout (matches io/kitti.py constants):
// upper 32 lasers +2.0°…−8.33° at 1/3° steps, lower 32 −8.83°…−24.33° at
// 1/2° steps.  A uniform split mis-assigns nearly every lower-block point.
inline int hdl64_ring(float elev_rad) {
  const float deg = elev_rad * 180.f / (float)M_PI;
  int ring;
  if (deg > -8.58f) {
    ring = (int)std::lround((2.0f - deg) * 3.0f);          // 1/3° steps
  } else {
    ring = 32 + (int)std::lround((-8.83f - deg) * 2.0f);   // 1/2° steps
  }
  return ring < 0 ? 0 : (ring > 63 ? 63 : ring);
}

// Ring recovery from the .bin's native laser-major point order: each ring
// sweeps a full azimuth circle, so ring boundaries are |Δazimuth| > π jumps
// (exact regardless of elevation calibration; mirrors io/kitti.py
// recover_rings_scanorder).  Returns false if the detected ring count is
// implausible — caller falls back to the elevation model.
bool recover_rings_scanorder(const float* xyz, int64_t n_pts, int num_rings,
                             std::vector<int>& ring_out) {
  if (n_pts < num_rings * 8) return false;
  std::vector<int64_t> boundaries;
  float prev = std::atan2(xyz[1], xyz[0]);
  for (int64_t i = 1; i < n_pts; ++i) {
    const float a = std::atan2(xyz[i * 4 + 1], xyz[i * 4 + 0]);
    if (std::fabs(a - prev) > (float)M_PI) boundaries.push_back(i);
    prev = a;
  }
  const int64_t n_rings = (int64_t)boundaries.size() + 1;
  if (n_rings < (int64_t)(0.8 * num_rings) ||
      n_rings > (int64_t)(1.5 * num_rings))
    return false;
  ring_out.assign(n_pts, 0);
  int seg = 0;
  int64_t next_b = boundaries.empty() ? n_pts : boundaries[0];
  size_t bi = 0;
  for (int64_t i = 0; i < n_pts; ++i) {
    if (i == next_b) {
      ++seg;
      ++bi;
      next_b = bi < boundaries.size() ? boundaries[bi] : n_pts;
    }
    ring_out[i] = seg;
  }
  if (n_rings > num_rings) {
    // merge spurious splits: drop the (n_rings - num_rings) shortest
    // segments, renumbering the rest (mirror of the python logic)
    std::vector<int64_t> seg_len(n_rings, 0);
    for (int64_t i = 0; i < n_pts; ++i) seg_len[ring_out[i]]++;
    std::vector<int> order(n_rings);
    for (int i = 0; i < (int)n_rings; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int a, int b) {
      return seg_len[a] != seg_len[b] ? seg_len[a] < seg_len[b] : a < b;
    });
    std::vector<uint8_t> keep(n_rings, 1);
    for (int64_t k = 0; k < n_rings - num_rings; ++k) keep[order[k]] = 0;
    std::vector<int> remap(n_rings, 0);
    int acc = -1;
    for (int64_t i = 0; i < n_rings; ++i) {
      if (keep[i]) ++acc;
      remap[i] = acc < 0 ? 0 : acc;
    }
    for (int64_t i = 0; i < n_pts; ++i) {
      int r = remap[ring_out[i]];
      ring_out[i] = r < 0 ? 0 : (r >= num_rings ? num_rings - 1 : r);
    }
  }
  return true;
}

// Regrid a raw (n,4) velodyne float buffer into (rings, W) range image.
// Closest point per cell wins.  Parallel over input chunks with per-thread
// buffers merged at the end (deterministic given identical inputs).
void regrid(const float* xyz, int64_t n_pts, const GridCfg& cfg,
            float* ranges, float* points, uint8_t* valid) {
  const int R = cfg.rings, W = cfg.width;
  const float lo = cfg.vfov_lo_deg * (float)M_PI / 180.f;
  const float hi = cfg.vfov_hi_deg * (float)M_PI / 180.f;
  const int64_t cells = (int64_t)R * W;
  std::fill(ranges, ranges + cells, 0.f);
  std::fill(points, points + cells * 3, 0.f);
  std::fill(valid, valid + cells, 0);

  std::vector<int> rings_rec;
  bool have_rec = false;
  bool use_hdl64 = false;
  if (R == 64 && cfg.ring_mode == 2)
    have_rec = recover_rings_scanorder(xyz, n_pts, R, rings_rec);
  if (R == 64 && !have_rec &&
      (cfg.ring_mode == 1 || cfg.ring_mode == 2))
    use_hdl64 = true;

  int n_threads = std::max(1u, std::thread::hardware_concurrency());
  if (n_pts < 20000) n_threads = 1;
  std::vector<std::vector<float>> t_range(n_threads);
  std::vector<std::vector<int64_t>> t_idx(n_threads);

  auto worker = [&](int tid) {
    auto& rng = t_range[tid];
    auto& idx = t_idx[tid];
    rng.assign(cells, 0.f);
    idx.assign(cells, -1);
    const int64_t begin = n_pts * tid / n_threads;
    const int64_t end = n_pts * (tid + 1) / n_threads;
    for (int64_t i = begin; i < end; ++i) {
      const float x = xyz[i * 4 + 0], y = xyz[i * 4 + 1], z = xyz[i * 4 + 2];
      const float r = std::sqrt(x * x + y * y + z * z);
      if (r <= cfg.min_range || r >= cfg.max_range) continue;
      const float elev = std::asin(z / r);
      int ring;
      if (have_rec)
        ring = rings_rec[i];
      else if (use_hdl64)
        ring = hdl64_ring(elev);
      else
        ring = (int)std::lround((hi - elev) / (hi - lo) * (R - 1));
      if (ring < 0 || ring >= R) continue;
      const float azim = std::atan2(y, x);
      // centered binning, consistent with io/kitti.py scan_to_range_image
      int col = (int)std::lround((azim + (float)M_PI) / (2.f * (float)M_PI) * W) % W;
      if (col < 0) col += W;
      const int64_t c = (int64_t)ring * W + col;
      if (idx[c] < 0 || r < rng[c]) {
        rng[c] = r;
        idx[c] = i;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();

  for (int64_t c = 0; c < cells; ++c) {
    float best = 0.f;
    int64_t bi = -1;
    for (int t = 0; t < n_threads; ++t) {
      if (t_idx[t][c] >= 0 && (bi < 0 || t_range[t][c] < best)) {
        best = t_range[t][c];
        bi = t_idx[t][c];
      }
    }
    if (bi >= 0) {
      ranges[c] = best;
      points[c * 3 + 0] = xyz[bi * 4 + 0];
      points[c * 3 + 1] = xyz[bi * 4 + 1];
      points[c * 3 + 2] = xyz[bi * 4 + 2];
      valid[c] = 1;
    }
  }
}

struct Frame {
  int index = -1;
  std::vector<float> ranges, points;
  std::vector<uint8_t> valid;
};

// Threaded prefetching loader over <dir>/NNNNNN.bin files.
struct Loader {
  GridCfg cfg;
  std::string dir;
  int n_frames = 0;
  int prefetch = 4;
  std::deque<Frame> queue;
  int next_to_read = 0;
  int next_to_pop = 0;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::thread worker;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] {
          return stop.load() || ((int)queue.size() < prefetch &&
                                 next_to_read < n_frames);
        });
        if (stop.load() || next_to_read >= n_frames) {
          if (next_to_read >= n_frames) return;
          continue;
        }
        idx = next_to_read++;
      }
      char name[64];
      std::snprintf(name, sizeof(name), "/%06d.bin", idx);
      std::string path = dir + name;
      std::vector<float> raw;
      if (FILE* f = std::fopen(path.c_str(), "rb")) {
        std::fseek(f, 0, SEEK_END);
        long sz = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        raw.resize(sz / sizeof(float));
        size_t got = std::fread(raw.data(), sizeof(float), raw.size(), f);
        raw.resize(got);
        std::fclose(f);
      }
      Frame fr;
      fr.index = idx;
      const int64_t cells = (int64_t)cfg.rings * cfg.width;
      fr.ranges.resize(cells);
      fr.points.resize(cells * 3);
      fr.valid.resize(cells);
      regrid(raw.data(), (int64_t)(raw.size() / 4), cfg, fr.ranges.data(),
             fr.points.data(), fr.valid.data());
      {
        std::lock_guard<std::mutex> lk(mu);
        queue.push_back(std::move(fr));
      }
      cv_pop.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// ---- one-shot regrid ------------------------------------------------------
// ring_mode: 0=uniform elevation, 1=hdl64 two-block, 2=auto (scan-order
// recovery with hdl64 fallback; applies when rings==64).
void lmono_regrid(const float* xyz, int64_t n_pts, int rings, int width,
                  float vfov_lo_deg, float vfov_hi_deg, float min_range,
                  float max_range, int ring_mode, float* ranges_out,
                  float* points_out, uint8_t* valid_out) {
  GridCfg cfg{rings,     width,     vfov_lo_deg, vfov_hi_deg,
              min_range, max_range, ring_mode};
  regrid(xyz, n_pts, cfg, ranges_out, points_out, valid_out);
}

// ---- prefetching loader ---------------------------------------------------
void* lmono_loader_create(const char* dir, int n_frames, int rings, int width,
                          float vfov_lo_deg, float vfov_hi_deg,
                          float min_range, float max_range, int ring_mode,
                          int prefetch) {
  auto* ld = new Loader();
  ld->cfg = GridCfg{rings,     width,     vfov_lo_deg, vfov_hi_deg,
                    min_range, max_range, ring_mode};
  ld->dir = dir;
  ld->n_frames = n_frames;
  ld->prefetch = prefetch > 0 ? prefetch : 4;
  ld->worker = std::thread([ld] { ld->run(); });
  return ld;
}

// Blocks until the next frame is ready; returns its index or -1 at end.
int lmono_loader_next(void* handle, float* ranges_out, float* points_out,
                      uint8_t* valid_out) {
  auto* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(ld->mu);
  if (ld->next_to_pop >= ld->n_frames) return -1;
  ld->cv_pop.wait(lk, [&] { return !ld->queue.empty() || ld->stop.load(); });
  if (ld->queue.empty()) return -1;
  Frame fr = std::move(ld->queue.front());
  ld->queue.pop_front();
  ld->next_to_pop++;
  lk.unlock();
  ld->cv_push.notify_all();
  const size_t cells = fr.ranges.size();
  std::memcpy(ranges_out, fr.ranges.data(), cells * sizeof(float));
  std::memcpy(points_out, fr.points.data(), cells * 3 * sizeof(float));
  std::memcpy(valid_out, fr.valid.data(), cells);
  return fr.index;
}

void lmono_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  ld->stop.store(true);
  ld->cv_push.notify_all();
  ld->cv_pop.notify_all();
  if (ld->worker.joinable()) ld->worker.join();
  delete ld;
}

// ---- PLY writer -----------------------------------------------------------
int64_t lmono_ply_write(const char* path, const float* xyz,
                        const uint8_t* rgb, int64_t n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f,
               "ply\nformat binary_little_endian 1.0\n"
               "element vertex %lld\n"
               "property float x\nproperty float y\nproperty float z\n"
               "property uchar red\nproperty uchar green\nproperty uchar "
               "blue\nend_header\n",
               (long long)n);
  for (int64_t i = 0; i < n; ++i) {
    std::fwrite(xyz + i * 3, sizeof(float), 3, f);
    std::fwrite(rgb + i * 3, 1, 3, f);
  }
  std::fclose(f);
  return n;
}

}  // extern "C"
