// Batched contact-schedule discretizer, host C++.
//
// The port's own copy of the JAX package's native/schedule.cpp (the same
// algorithm, line for line). In an MPC loop over thousands of scenarios the
// per-control-step host work is computing each scenario's HorizonSchedule
// masks from its contact sequence; this does it for the whole batch in one
// call.
//
// Semantics mirror idocp_tpu_torch/hybrid/schedule.py::ContactSequence.
// discretize (tests hold it against that and against the JAX package's
// library, bit for bit).
//
// Built with the host C++ compiler at first use by hybrid/native.py
// (c++ -O3 -fPIC -shared -std=c++17) and loaded with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// All arrays are C-contiguous, caller-allocated.
//   ev_time:    (B, max_ev)        event times (only first n_events[b] used)
//   ev_active:  (B, max_ev, nc)    contact set AFTER each event
//   ev_pos:     (B, max_ev, nc*3)  contact positions after each event
//   init_*:     status before the first event
// Outputs match HorizonSchedule fields, flattened.
void discretize_batch(
    const int64_t B, const int64_t N, const int64_t nc,
    const double* t0, const double T,
    const int64_t max_ev, const int64_t* n_events,
    const double* ev_time, const uint8_t* ev_active, const double* ev_pos,
    const uint8_t* init_active, const double* init_pos,
    const double min_dt_frac,
    double* dt, double* t_offset,
    uint8_t* contact_active, double* contact_pos,
    uint8_t* imp_mask, uint8_t* imp_contact,
    uint8_t* sw_contact, double* sw_pos) {
  const double dt0 = T / static_cast<double>(N);
  std::vector<double> bounds(N + 1);
  std::vector<int64_t> snapped(N + 1);

  for (int64_t b = 0; b < B; ++b) {
    const double tb = t0[b];
    for (int64_t k = 0; k <= N; ++k) {
      bounds[k] = tb + dt0 * static_cast<double>(k);
      snapped[k] = -1;
    }
    bounds[N] = tb + T;  // exact right edge

    const int64_t ne = n_events[b];
    const double* evt = ev_time + b * max_ev;
    // snap nearest boundary to each in-horizon event
    for (int64_t e = 0; e < ne; ++e) {
      const double te = evt[e];
      if (te <= tb || te >= tb + T) continue;
      int64_t idx = static_cast<int64_t>(std::lround((te - tb) / dt0));
      if (idx < 1) idx = 1;
      if (idx > N - 1) idx = N - 1;
      while (snapped[idx] >= 0 && idx < N - 1) ++idx;
      if (snapped[idx] >= 0) continue;
      bounds[idx] = te;
      snapped[idx] = e;
    }
    // Monotonicity with minimum step, robust to events crowding either
    // horizon edge (mirrors schedule.py exactly): clip each boundary into
    // [tb + k*min_dt, tb+T - (N-k)*min_dt], then one forward pass.
    const double min_dt = min_dt_frac * dt0;
    for (int64_t k = 0; k <= N; ++k) {
      const double lo = tb + static_cast<double>(k) * min_dt;
      const double hi = (tb + T) - static_cast<double>(N - k) * min_dt;
      if (bounds[k] < lo) bounds[k] = lo;
      if (bounds[k] > hi) bounds[k] = hi;
    }
    for (int64_t k = 1; k < N; ++k) {
      const double lim = bounds[k - 1] + min_dt;
      if (bounds[k] < lim) bounds[k] = lim;
    }

    // helper: status strictly at time t (last event with time <= t)
    auto status_at = [&](double t, const uint8_t** act, const double** pos) {
      *act = init_active + b * nc;
      *pos = init_pos + b * nc * 3;
      for (int64_t e = 0; e < ne; ++e) {
        if (evt[e] <= t) {
          *act = ev_active + (b * max_ev + e) * nc;
          *pos = ev_pos + (b * max_ev + e) * nc * 3;
        } else {
          break;
        }
      }
    };

    for (int64_t k = 0; k < N; ++k) {
      const int64_t ok = b * N + k;
      dt[ok] = bounds[k + 1] - bounds[k];
      t_offset[ok] = bounds[k] - tb;
      const uint8_t* act;
      const double* pos;
      status_at(bounds[k] + 1e-12, &act, &pos);
      std::memcpy(contact_active + ok * nc, act, nc);
      std::memcpy(contact_pos + ok * nc * 3, pos, nc * 3 * sizeof(double));
      imp_mask[ok] = 0;
      std::memset(imp_contact + ok * nc, 0, nc);
      std::memset(sw_contact + ok * nc, 0, nc);
      std::memset(sw_pos + ok * nc * 3, 0, nc * 3 * sizeof(double));
    }
    for (int64_t k = 0; k < N; ++k) {
      if (snapped[k] < 0) continue;
      const int64_t e = snapped[k];
      const uint8_t* prev_act;
      const double* prev_pos;
      status_at(evt[e] - 1e-9, &prev_act, &prev_pos);
      const uint8_t* new_act = ev_active + (b * max_ev + e) * nc;
      const double* new_pos = ev_pos + (b * max_ev + e) * nc * 3;
      bool any_new = false;
      const int64_t ok = b * N + k;
      for (int64_t c = 0; c < nc; ++c) {
        const uint8_t is_new = new_act[c] && !prev_act[c];
        imp_contact[ok * nc + c] = is_new;
        any_new = any_new || is_new;
      }
      if (any_new) {
        imp_mask[ok] = 1;
        if (k > 0) {
          const int64_t op = b * N + (k - 1);
          for (int64_t c = 0; c < nc; ++c) {
            sw_contact[op * nc + c] = imp_contact[ok * nc + c];
          }
          std::memcpy(sw_pos + op * nc * 3, new_pos,
                      nc * 3 * sizeof(double));
        }
      } else {
        std::memset(imp_contact + ok * nc, 0, nc);
      }
    }
  }
}

}  // extern "C"
