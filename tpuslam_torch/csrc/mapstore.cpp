// Native map store: the covisibility graph of tpuslam_torch's SlamMap as
// flat C arrays, driven through ctypes by tpuslam_torch/slammap/native.py.
// Host C++ with a C interface; no CUDA. It is this package's own copy of the
// JAX package's native/mapstore.cpp, built with the same g++ flags, so the
// two answer every query alike, the order of covisibility ties included.
//
// Design notes:
// - fixed capacities (landmarks, keyframes, features/KF) chosen at init;
//   all storage is flat arrays -> zero allocation on the per-frame path.
// - observations are stored per landmark as small open arrays (cap MAX_OBS)
//   and mirrored per keyframe as feature-slot -> landmark id.
// - covisibility counting is a single pass over a keyframe's bound slots,
//   accumulating into a dense per-keyframe counter scratch (O(K * obs)),
//   then std::sort by count, descending (not stable: ties fall in the
//   order this compiler's sort leaves them, the order SlamMap then keeps).
// - no threads, no locks: one writer on the host.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr int MAX_OBS = 32;  // observations tracked per landmark

struct Store {
  int32_t line_cap = 0;
  int32_t kf_cap = 0;
  int32_t feat_cap = 0;

  // landmarks
  std::vector<uint8_t> alive;       // [line_cap]
  std::vector<int32_t> n_obs;       // [line_cap]
  std::vector<int32_t> first_kf;    // [line_cap]
  std::vector<int32_t> obs_kf;      // [line_cap * MAX_OBS]
  std::vector<int32_t> obs_slot;    // [line_cap * MAX_OBS]
  std::vector<int32_t> free_list;
  int32_t next_line = 0;

  // keyframes
  std::vector<uint8_t> kf_alive;    // [kf_cap]
  std::vector<int32_t> line_ids;    // [kf_cap * feat_cap]

  // scratch
  std::vector<int32_t> counter;     // [kf_cap]
  std::vector<int32_t> touched;

  Store(int32_t lc, int32_t kc, int32_t fc)
      : line_cap(lc), kf_cap(kc), feat_cap(fc) {
    alive.assign(lc, 0);
    n_obs.assign(lc, 0);
    first_kf.assign(lc, -1);
    obs_kf.assign(size_t(lc) * MAX_OBS, -1);
    obs_slot.assign(size_t(lc) * MAX_OBS, -1);
    kf_alive.assign(kc, 0);
    line_ids.assign(size_t(kc) * size_t(fc), -1);
    counter.assign(kc, 0);
    touched.reserve(kc);
  }

  int32_t* obs_kf_row(int32_t lid) { return obs_kf.data() + size_t(lid) * MAX_OBS; }
  int32_t* obs_slot_row(int32_t lid) { return obs_slot.data() + size_t(lid) * MAX_OBS; }
  int32_t* kf_row(int32_t kid) { return line_ids.data() + size_t(kid) * feat_cap; }
};

}  // namespace

extern "C" {

void* ms_create(int32_t line_cap, int32_t kf_cap, int32_t feat_cap) {
  return new Store(line_cap, kf_cap, feat_cap);
}

void ms_destroy(void* h) { delete static_cast<Store*>(h); }

void ms_add_keyframe(void* h, int32_t kid) {
  Store& s = *static_cast<Store*>(h);
  if (kid < 0 || kid >= s.kf_cap) return;
  s.kf_alive[kid] = 1;
  std::fill(s.kf_row(kid), s.kf_row(kid) + s.feat_cap, -1);
}

// Returns the allocated landmark id, or -1 when out of capacity.
int32_t ms_allocate(void* h, int32_t first_kf) {
  Store& s = *static_cast<Store*>(h);
  int32_t lid;
  if (!s.free_list.empty()) {
    lid = s.free_list.back();
    s.free_list.pop_back();
  } else {
    if (s.next_line >= s.line_cap) return -1;
    lid = s.next_line++;
  }
  s.alive[lid] = 1;
  s.n_obs[lid] = 0;
  s.first_kf[lid] = first_kf;
  std::fill(s.obs_kf_row(lid), s.obs_kf_row(lid) + MAX_OBS, -1);
  return lid;
}

int32_t ms_add_observation(void* h, int32_t lid, int32_t kid, int32_t slot) {
  Store& s = *static_cast<Store*>(h);
  if (lid < 0 || lid >= s.line_cap || !s.alive[lid]) return 0;
  if (kid < 0 || kid >= s.kf_cap || slot < 0 || slot >= s.feat_cap) return 0;
  int32_t* kfs = s.obs_kf_row(lid);
  int32_t* slots = s.obs_slot_row(lid);
  int free_i = -1;
  for (int i = 0; i < MAX_OBS; ++i) {
    if (kfs[i] == kid) {
      // re-bind to a new slot: clear the stale previous-slot entry first
      int32_t prev = slots[i];
      if (prev >= 0 && prev != slot && s.kf_row(kid)[prev] == lid)
        s.kf_row(kid)[prev] = -1;
      slots[i] = slot;
      s.kf_row(kid)[slot] = lid;
      return 1;
    }
    if (kfs[i] < 0 && free_i < 0) free_i = i;
  }
  if (free_i < 0) return 0;  // observation list full
  kfs[free_i] = kid;
  slots[free_i] = slot;
  s.n_obs[lid]++;
  s.kf_row(kid)[slot] = lid;
  return 1;
}

void ms_erase_observation(void* h, int32_t lid, int32_t kid) {
  Store& s = *static_cast<Store*>(h);
  if (lid < 0 || lid >= s.line_cap) return;
  int32_t* kfs = s.obs_kf_row(lid);
  int32_t* slots = s.obs_slot_row(lid);
  for (int i = 0; i < MAX_OBS; ++i) {
    if (kfs[i] == kid) {
      int32_t slot = slots[i];
      if (slot >= 0 && s.kf_row(kid)[slot] == lid) s.kf_row(kid)[slot] = -1;
      kfs[i] = -1;
      slots[i] = -1;
      s.n_obs[lid]--;
      return;
    }
  }
}

void ms_kill(void* h, int32_t lid) {
  Store& s = *static_cast<Store*>(h);
  if (lid < 0 || lid >= s.line_cap || !s.alive[lid]) return;
  int32_t* kfs = s.obs_kf_row(lid);
  int32_t* slots = s.obs_slot_row(lid);
  for (int i = 0; i < MAX_OBS; ++i) {
    if (kfs[i] >= 0 && slots[i] >= 0 && s.kf_row(kfs[i])[slots[i]] == lid)
      s.kf_row(kfs[i])[slots[i]] = -1;
    kfs[i] = -1;
    slots[i] = -1;
  }
  s.alive[lid] = 0;
  s.n_obs[lid] = 0;
  s.free_list.push_back(lid);
}

// Move `old_id`'s observations onto `new_id` (duplicate fusion). Keyframes
// already observing new_id keep that binding; old_id dies.
void ms_replace(void* h, int32_t old_id, int32_t new_id) {
  Store& s = *static_cast<Store*>(h);
  if (old_id == new_id || old_id < 0 || new_id < 0) return;
  if (!s.alive[old_id] || !s.alive[new_id]) return;
  int32_t* okfs = s.obs_kf_row(old_id);
  int32_t* oslots = s.obs_slot_row(old_id);
  for (int i = 0; i < MAX_OBS; ++i) {
    int32_t kid = okfs[i];
    if (kid < 0) continue;
    int32_t slot = oslots[i];
    // does new_id already observe kid?
    bool has = false;
    int32_t* nkfs = s.obs_kf_row(new_id);
    for (int j = 0; j < MAX_OBS; ++j)
      if (nkfs[j] == kid) { has = true; break; }
    if (!has) {
      // on failure (new_id's observation list full) the keyframe slot must
      // not keep pointing at the dying old_id
      if (!ms_add_observation(h, new_id, kid, slot) && slot >= 0 &&
          s.kf_row(kid)[slot] == old_id)
        s.kf_row(kid)[slot] = -1;
    } else if (slot >= 0 && s.kf_row(kid)[slot] == old_id) {
      s.kf_row(kid)[slot] = -1;
    }
    okfs[i] = -1;
    oslots[i] = -1;
  }
  s.alive[old_id] = 0;
  s.n_obs[old_id] = 0;
  s.free_list.push_back(old_id);
}

int32_t ms_n_obs(void* h, int32_t lid) {
  Store& s = *static_cast<Store*>(h);
  return (lid >= 0 && lid < s.line_cap) ? s.n_obs[lid] : 0;
}

int32_t ms_alive(void* h, int32_t lid) {
  Store& s = *static_cast<Store*>(h);
  return (lid >= 0 && lid < s.line_cap) ? s.alive[lid] : 0;
}

// Copy keyframe kid's feature-slot -> landmark-id row into out[feat_cap].
void ms_get_line_ids(void* h, int32_t kid, int32_t* out) {
  Store& s = *static_cast<Store*>(h);
  std::memcpy(out, s.kf_row(kid), sizeof(int32_t) * s.feat_cap);
}

// Covisibility of keyframe `kid`: counts of shared landmarks with every
// other keyframe. Writes up to max_out (other_kid, count) pairs sorted by
// count desc; returns the number written.
int32_t ms_covisibility(void* h, int32_t kid, int32_t min_weight,
                        int32_t* out_kids, int32_t* out_counts,
                        int32_t max_out) {
  Store& s = *static_cast<Store*>(h);
  s.touched.clear();
  const int32_t* row = s.kf_row(kid);
  for (int32_t slot = 0; slot < s.feat_cap; ++slot) {
    int32_t lid = row[slot];
    if (lid < 0 || !s.alive[lid]) continue;
    const int32_t* kfs = s.obs_kf_row(lid);
    for (int i = 0; i < MAX_OBS; ++i) {
      int32_t other = kfs[i];
      if (other < 0 || other == kid || !s.kf_alive[other]) continue;
      if (s.counter[other]++ == 0) s.touched.push_back(other);
    }
  }
  // gather + sort by count desc
  std::vector<std::pair<int32_t, int32_t>> items;
  items.reserve(s.touched.size());
  for (int32_t other : s.touched) {
    if (s.counter[other] >= min_weight) items.emplace_back(s.counter[other], other);
    s.counter[other] = 0;
  }
  std::sort(items.begin(), items.end(),
            [](auto& a, auto& b) { return a.first > b.first; });
  int32_t n = std::min<int32_t>(items.size(), max_out);
  for (int32_t i = 0; i < n; ++i) {
    out_counts[i] = items[i].first;
    out_kids[i] = items[i].second;
  }
  return n;
}

// Landmark ids observed by a window of keyframes (union), up to max_out.
int32_t ms_window_lines(void* h, const int32_t* kids, int32_t n_kids,
                        int32_t* out_lines, int32_t max_out) {
  Store& s = *static_cast<Store*>(h);
  std::vector<int32_t> out;
  std::vector<uint8_t> seen(s.line_cap, 0);
  for (int32_t k = 0; k < n_kids; ++k) {
    const int32_t* row = s.kf_row(kids[k]);
    for (int32_t slot = 0; slot < s.feat_cap; ++slot) {
      int32_t lid = row[slot];
      if (lid >= 0 && s.alive[lid] && !seen[lid]) {
        seen[lid] = 1;
        out.push_back(lid);
      }
    }
  }
  std::sort(out.begin(), out.end());
  int32_t n = std::min<int32_t>(out.size(), max_out);
  std::memcpy(out_lines, out.data(), sizeof(int32_t) * n);
  return n;
}

// Observation table for BA assembly: for each landmark in `lines`, emit
// (line_index, kf_id, slot) triples; returns count (bounded by max_out).
int32_t ms_observations(void* h, const int32_t* lines, int32_t n_lines,
                        int32_t* out_line_idx, int32_t* out_kids,
                        int32_t* out_slots, int32_t max_out) {
  Store& s = *static_cast<Store*>(h);
  int32_t n = 0;
  for (int32_t i = 0; i < n_lines && n < max_out; ++i) {
    int32_t lid = lines[i];
    if (lid < 0 || lid >= s.line_cap || !s.alive[lid]) continue;
    const int32_t* kfs = s.obs_kf_row(lid);
    const int32_t* slots = s.obs_slot_row(lid);
    for (int j = 0; j < MAX_OBS && n < max_out; ++j) {
      if (kfs[j] >= 0 && s.kf_alive[kfs[j]]) {
        out_line_idx[n] = i;
        out_kids[n] = kfs[j];
        out_slots[n] = slots[j];
        ++n;
      }
    }
  }
  return n;
}

void ms_remove_keyframe(void* h, int32_t kid) {
  Store& s = *static_cast<Store*>(h);
  if (kid < 0 || kid >= s.kf_cap || !s.kf_alive[kid]) return;
  const int32_t* row = s.kf_row(kid);
  for (int32_t slot = 0; slot < s.feat_cap; ++slot) {
    int32_t lid = row[slot];
    if (lid >= 0) ms_erase_observation(h, lid, kid);
  }
  s.kf_alive[kid] = 0;
}

}  // extern "C"
