// Derivatives of the inverse dynamics of a batch of stages for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (idocp_tpu/robot/spatial.py: motion's sensitivities, rnea_derivatives,
// contact_forces_dq, point_pva_derivatives, fused by its compiler). The port
// ran it as some 400 eager PyTorch operations a call on dense sensitivity
// tensors, (stages, nv, nb, 6) and (stages, nv, nv, 6), each written to and
// read back from device memory: about 50 times the bytes the result needs.
// Here the sensitivities live in registers and shared memory only.
//
// For every stage it writes, from the world-frame FK bundle (motion subspace
// S, com c and rotational inertia Ic of each body), v, a, the subtree force
// sums F and the contact points p with their forces fm:
//   dtau_q, dtau_v  (nv, nv)     the inverse dynamics' tangent Jacobians
//   dvel_q, dvel_v  (nc, 3, nv)  the contact points' velocity Jacobians
//   dacc_q, dacc_v  (nc, 3, nv)  their classical acceleration Jacobians
// with the closed forms of robot/spatial.py, column j = input dof j:
//   dV_i/dq_j = S_j x (V_i - B_j),  dV_i/dv_j = S_j          (i below body(j))
//   dA_i/dq_j = dA_parent(i)/dq_j + sum_{k on i} [dS_jk a_k
//               + (dV_i/dq_j x S_k) v_k + (V_i x dS_jk) v_k],  dS_jk = S_j x S_k
//   dA_i/dv_j = V_body(j) x S_j + S_j x (V_i - V_parent(body(j)))
//   df_i = S_j x* (I A) + I (dA - S_j x A) + dV x* (I V)
//          + V x* (S_j x* (I V) + I (dV - S_j x V)) - [dp_c/dq_j x fm_c, 0]
//   dF_i = sum over the subtree of i,  dtau_mj = S_m . dF_body(m) + dS_jm . F
// The ancestor and descendant sums of the dense form (its 0-1 masks) become a
// forward and a backward pass over the bodies in tree order; a body outside
// the subtree of body(j) has no derivative, and an ancestor of body(j) has
// that of body(j).
//
// What bounds it on this card: bytes in principle (about 2 K numbers a stage
// in and out against some 50 K operations), but as written the f64
// arithmetic of the lanes and their shared-memory traffic: the work of a
// column is serial over the bodies, and the columns of one stage differ in
// length (a base column walks every body, a foot column one).
//
// Layout: a group of nv lanes takes one stage, lane j its column j; a warp
// takes 32 / nv consecutive stages (1 for ANYmal, nv = 18; 4 for iiwa14,
// nv = 7). The warp copies its stages' inputs into its own piece of dynamic
// shared memory with lanes on consecutive addresses, each group then computes
// its stage's V, A, I V and I A (lanes over components and bodies), and each
// lane runs its column: dA/dq forward into a per-lane slot per body (X), the
// contact rows from it, then df backward into dF (X, Y; the children's slots
// pulled), dtau's column into a per-lane slice (DT). A stage's lanes read
// only that stage: a NaN stays in its stage. The warp writes dtau from DT
// with lanes on consecutive addresses; the contact rows go out from the
// lanes' registers, a row of nv consecutive numbers at a time.
//
// The static tree comes as one int32 array (robot/spatial.py::
// _kernel_topology): per body parent, first dof, dofs, first child, next
// sibling, ancestor-or-self bit mask; per dof its body and whether it is a
// FREE joint's; per contact its body. Parents come before children; nb and
// nv are at most 32.
//
// Plain C interface (loaded with ctypes): the function launches on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError(). A null F skips dtau, a null fm the external forces, a
// null gravity the gravity offset, a null dvel_q every contact row and a
// null dacc_q the acceleration rows.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> operator+(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator-(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <typename T>
__device__ __forceinline__ V3<T> operator*(V3<T> a, T s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// A spatial motion or force in the world frame at the origin, angular first.
template <typename T>
struct M6 {
  V3<T> w, v;
};

template <typename T>
__device__ __forceinline__ M6<T> operator+(M6<T> a, M6<T> b) {
  return {a.w + b.w, a.v + b.v};
}
template <typename T>
__device__ __forceinline__ M6<T> operator-(M6<T> a, M6<T> b) {
  return {a.w - b.w, a.v - b.v};
}
template <typename T>
__device__ __forceinline__ M6<T> operator*(M6<T> a, T s) {
  return {a.w * s, a.v * s};
}
template <typename T>
__device__ __forceinline__ T dot(M6<T> a, M6<T> b) {
  return dot(a.w, b.w) + dot(a.v, b.v);
}
template <typename T>
__device__ __forceinline__ M6<T> zero6() {
  return {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
}
// motion cross product a x b
template <typename T>
__device__ __forceinline__ M6<T> crm(M6<T> a, M6<T> b) {
  return {cross(a.w, b.w), cross(a.w, b.v) + cross(a.v, b.w)};
}
// force cross product m x* f
template <typename T>
__device__ __forceinline__ M6<T> crf(M6<T> m, M6<T> f) {
  return {cross(m.w, f.w) + cross(m.v, f.v), cross(m.w, f.v)};
}

template <typename T>
__device__ __forceinline__ V3<T> ld3(const T* p) {
  return {p[0], p[1], p[2]};
}
template <typename T>
__device__ __forceinline__ M6<T> ld6(const T* p) {
  return {{p[0], p[1], p[2]}, {p[3], p[4], p[5]}};
}
template <typename T>
__device__ __forceinline__ void st6(T* p, M6<T> m) {
  p[0] = m.w.x; p[1] = m.w.y; p[2] = m.w.z;
  p[3] = m.v.x; p[4] = m.v.y; p[5] = m.v.z;
}
// a lane's slot: six numbers `stride` apart (the lanes' slots interleaved)
template <typename T>
__device__ __forceinline__ M6<T> ld6s(const T* p, int stride) {
  return {{p[0], p[stride], p[2 * stride]},
          {p[3 * stride], p[4 * stride], p[5 * stride]}};
}
template <typename T>
__device__ __forceinline__ void st6s(T* p, int stride, M6<T> m) {
  p[0] = m.w.x; p[stride] = m.w.y; p[2 * stride] = m.w.z;
  p[3 * stride] = m.v.x; p[4 * stride] = m.v.y; p[5 * stride] = m.v.z;
}

// h = I m for the inertia (mass, com c, rotational inertia Ic about the com,
// row-major), world frame at the origin.
template <typename T>
__device__ __forceinline__ M6<T> inertia(T mass, const T* c, const T* Ic, M6<T> m) {
  const V3<T> cv = ld3(c);
  const V3<T> p = (m.v + cross(m.w, cv)) * mass;
  const V3<T> L = {Ic[0] * m.w.x + Ic[1] * m.w.y + Ic[2] * m.w.z,
                   Ic[3] * m.w.x + Ic[4] * m.w.y + Ic[5] * m.w.z,
                   Ic[6] * m.w.x + Ic[7] * m.w.y + Ic[8] * m.w.z};
  return {L + cross(cv, p), p};
}

template <typename T>
struct Params {
  const int* topo;
  int nb, nv, nc;
  long long stages;
  int groups, warps;  // stages per warp, warps per block
  const T* S;         // (stages, nv, 6)
  const T* v;         // (stages, nv)
  const T* a;         // (stages, nv)
  const T* c;         // (stages, nb, 3)
  const T* Ic;        // (stages, nb, 3, 3)
  const T* mass;      // (nb,)
  const T* gravity;   // (3,) or null
  const T* F;         // (stages, nb, 6) or null
  const T* p;         // (stages, nc, 3) or null
  const T* fm;        // (stages, nc, 3) or null
  T* dtau_q;          // (stages, nv, nv) or null (with F)
  T* dtau_v;
  T* dvel_q;          // (stages, nc, 3, nv) or null
  T* dvel_v;
  T* dacc_q;          // (stages, nc, 3, nv) or null
  T* dacc_v;
};

__host__ __device__ inline int topo_ints(int nb, int nv, int nc) { return 6 * nb + 2 * nv + nc; }

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// bytes of a block's head: the tree, then the bodies' masses
__host__ __device__ inline int head_bytes(int nb, int nv, int nc, int itemsize) {
  return round16(4 * topo_ints(nb, nv, nc)) + round16(itemsize * nb);
}

// numbers of one stage's inputs and per-stage intermediates in shared memory
__host__ __device__ inline int stage_numbers(int nb, int nv, int nc) {
  return 14 * nv + 42 * nb + 6 * nc;
}

// numbers of one warp's piece: its stages', then the lanes' slots X, Y, DT
__host__ __device__ inline int warp_numbers(int nb, int nv, int nc, int groups) {
  const int lanes = groups * nv;
  return groups * stage_numbers(nb, nv, nc) + (12 * nb + 2 * nv) * lanes;
}

// The warp's copy of `len` numbers per stage for `count` stages, lanes on
// consecutive addresses.
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, long long stage0, int count,
                                        int len, int lane) {
  const T* from = src + stage0 * len;
  for (int e = lane; e < count * len; e += kWarp) dst[e] = from[e];
}

template <typename T>
__global__ void __launch_bounds__(256) id_derivatives_kernel(Params<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = P.nb, nv = P.nv, nc = P.nc, G = P.groups;
  const int nt = topo_ints(nb, nv, nc);
  int* topo = reinterpret_cast<int*>(smem_raw);
  for (int e = threadIdx.x; e < nt; e += blockDim.x) topo[e] = P.topo[e];
  T* mass = reinterpret_cast<T*>(smem_raw + round16(4 * nt));
  for (int e = threadIdx.x; e < nb; e += blockDim.x) mass[e] = P.mass[e];
  __syncthreads();

  const int* parent = topo;
  const int* vfirst = topo + nb;
  const int* ndof = topo + 2 * nb;
  const int* first_child = topo + 3 * nb;
  const int* next_sibling = topo + 4 * nb;
  const int* anc = topo + 5 * nb;
  const int* dof_body = topo + 6 * nb;
  const int* dof_base = topo + 6 * nb + nv;
  const int* contact_body = topo + 6 * nb + 2 * nv;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long stage0 = (static_cast<long long>(blockIdx.x) * P.warps + warp) * G;
  if (stage0 >= P.stages) return;  // the whole warp: no barrier follows for it
  const long long left = P.stages - stage0;
  const int count = left < G ? static_cast<int>(left) : G;
  const int LW = G * nv;  // lanes with a column

  T* piece = reinterpret_cast<T*>(smem_raw + head_bytes(nb, nv, nc, sizeof(T))) +
             warp * warp_numbers(nb, nv, nc, G);
  // per-stage arrays, each for the warp's G stages back to back
  T* S = piece;
  T* v = S + G * 6 * nv;
  T* a = v + G * nv;
  T* c = a + G * nv;
  T* Ic = c + G * 3 * nb;
  T* F = Ic + G * 9 * nb;
  T* p = F + G * 6 * nb;
  T* fm = p + G * 3 * nc;
  T* V = fm + G * 3 * nc;
  T* A = V + G * 6 * nb;
  T* Pm = A + G * 6 * nb;
  T* IA = Pm + G * 6 * nb;
  T* t1 = IA + G * 6 * nb;
  T* X = t1 + G * 6 * nv;  // (6 nb, LW)
  T* Y = X + 6 * nb * LW;  // (6 nb, LW)
  T* DT = Y + 6 * nb * LW; // (2 nv, LW)

  const bool has_F = P.F != nullptr;
  const bool has_rows = P.dvel_q != nullptr;
  const bool acc_rows = P.dacc_q != nullptr;
  const bool need_A = has_F || acc_rows;

  copy_in(S, P.S, stage0, count, 6 * nv, lane);
  copy_in(v, P.v, stage0, count, nv, lane);
  copy_in(a, P.a, stage0, count, nv, lane);
  copy_in(c, P.c, stage0, count, 3 * nb, lane);
  copy_in(Ic, P.Ic, stage0, count, 9 * nb, lane);
  if (has_F) copy_in(F, P.F, stage0, count, 6 * nb, lane);
  if (nc > 0) copy_in(p, P.p, stage0, count, 3 * nc, lane);
  if (P.fm != nullptr) copy_in(fm, P.fm, stage0, count, 3 * nc, lane);
  __syncwarp();

  // ---- the stage's motion: lanes over components, then dofs, then bodies
  const int g = lane / nv, l = lane % nv;
  const bool on = g < count;  // a lane with a column of a stage
  const T* Sg = S + g * 6 * nv;
  const T* vg = v + g * nv;
  const T* ag = a + g * nv;
  const T* cg = c + g * 3 * nb;
  const T* Icg = Ic + g * 9 * nb;
  const T* Fg = F + g * 6 * nb;
  const T* pg = p + g * 3 * nc;
  const T* fmg = fm + g * 3 * nc;
  T* Vg = V + g * 6 * nb;
  T* Ag = A + g * 6 * nb;
  T* Pg = Pm + g * 6 * nb;
  T* IAg = IA + g * 6 * nb;
  T* t1g = t1 + g * 6 * nv;
  if (on) {
    for (int k = l; k < 6; k += nv) {
      for (int i = 0; i < nb; ++i) {
        T s = parent[i] >= 0 ? Vg[6 * parent[i] + k] : T(0);
        for (int d = vfirst[i]; d < vfirst[i] + ndof[i]; ++d) s += Sg[6 * d + k] * vg[d];
        Vg[6 * i + k] = s;
      }
    }
  }
  __syncwarp();
  if (on) st6(t1g + 6 * l, crm(ld6(Vg + 6 * dof_body[l]), ld6(Sg + 6 * l)));
  __syncwarp();
  if (on && need_A) {
    for (int k = l; k < 6; k += nv) {
      const T a0 = (k >= 3 && P.gravity != nullptr) ? -P.gravity[k - 3] : T(0);
      for (int i = 0; i < nb; ++i) {
        T s = parent[i] >= 0 ? Ag[6 * parent[i] + k] : a0;
        for (int d = vfirst[i]; d < vfirst[i] + ndof[i]; ++d)
          s += Sg[6 * d + k] * ag[d] + t1g[6 * d + k] * vg[d];
        Ag[6 * i + k] = s;
      }
    }
  }
  __syncwarp();
  if (on) {
    for (int i = l; i < nb; i += nv) {
      st6(Pg + 6 * i, inertia(mass[i], cg + 3 * i, Icg + 9 * i, ld6(Vg + 6 * i)));
      if (need_A) st6(IAg + 6 * i, inertia(mass[i], cg + 3 * i, Icg + 9 * i, ld6(Ag + 6 * i)));
    }
  }
  __syncwarp();

  // ---- column j of the stage
  if (on) {
    const int j = l, bj = dof_body[j];
    const bool basej = dof_base[j] != 0;
    const unsigned bit = 1u << bj;
    const M6<T> Sj = ld6(Sg + 6 * j);
    const M6<T> Bj = basej ? zero6<T>() : ld6(Vg + 6 * bj);
    const M6<T> Vpar = parent[bj] >= 0 ? ld6(Vg + 6 * parent[bj]) : zero6<T>();
    const M6<T> t1j = ld6(t1g + 6 * j);
    T* Xl = X + lane;
    T* Yl = Y + lane;
    auto in_sub = [&](int i) { return (static_cast<unsigned>(anc[i]) & bit) != 0; };

    // forward: dA_i/dq_j into X
    if (need_A) {
      for (int i = bj; i < nb; ++i) {
        if (!in_sub(i)) continue;
        const M6<T> Vi = ld6(Vg + 6 * i);
        const M6<T> dVq = crm(Sj, Vi - Bj);
        M6<T> dAq = i == bj ? zero6<T>() : ld6s(Xl + 6 * parent[i] * LW, LW);
        for (int k = vfirst[i]; k < vfirst[i] + ndof[i]; ++k) {
          const M6<T> Sk = ld6(Sg + 6 * k);
          const bool cs = i != bj || (basej && dof_base[k] != 0);
          const M6<T> dS = cs ? crm(Sj, Sk) : zero6<T>();
          dAq = dAq + (dS * ag[k] + crm(dVq, Sk) * vg[k] + crm(Vi, dS) * vg[k]);
        }
        st6s(Xl + 6 * i * LW, LW, dAq);
      }
    }

    // the contact points' rows, each a row of nv consecutive numbers
    if (has_rows) {
      const long long stage = stage0 + g;
      for (int ci = 0; ci < nc; ++ci) {
        const int b = contact_body[ci];
        const bool hit = in_sub(b);
        const V3<T> pc = ld3(pg + 3 * ci);
        const M6<T> Vb = ld6(Vg + 6 * b);
        const V3<T> vel = Vb.v + cross(Vb.w, pc);
        const V3<T> Jt = Sj.v + cross(Sj.w, pc);
        const M6<T> dVq = crm(Sj, Vb - Bj);
        const V3<T> zero = {T(0), T(0), T(0)};
        const V3<T> dvq = hit ? dVq.v + cross(dVq.w, pc) + cross(Vb.w, Jt) : zero;
        const V3<T> dvv = hit ? Jt : zero;
        const long long row = (stage * nc + ci) * 3 * nv + j;
        P.dvel_q[row] = dvq.x; P.dvel_q[row + nv] = dvq.y; P.dvel_q[row + 2 * nv] = dvq.z;
        P.dvel_v[row] = dvv.x; P.dvel_v[row + nv] = dvv.y; P.dvel_v[row + 2 * nv] = dvv.z;
        if (acc_rows) {
          V3<T> daq = zero, dav = zero;
          if (hit) {
            const M6<T> dAq = ld6s(Xl + 6 * b * LW, LW);
            const M6<T> dAv = t1j + crm(Sj, Vb - Vpar);
            const V3<T> al = ld3(Ag + 6 * b);
            daq = dAq.v + cross(dAq.w, pc) + cross(al, Jt) + cross(dVq.w, vel) + cross(Vb.w, dvq);
            dav = dAv.v + cross(dAv.w, pc) + cross(Sj.w, vel) + cross(Vb.w, dvv);
          }
          P.dacc_q[row] = daq.x; P.dacc_q[row + nv] = daq.y; P.dacc_q[row + 2 * nv] = daq.z;
          P.dacc_v[row] = dav.x; P.dacc_v[row + nv] = dav.y; P.dacc_v[row + 2 * nv] = dav.z;
        }
      }
    }

    // backward: df into the subtree sums dF (X, Y), dtau's column into DT
    if (has_F) {
      for (int m = 0; m < 2 * nv; ++m) DT[m * LW + lane] = T(0);
      M6<T> dFq_bj = zero6<T>(), dFv_bj = zero6<T>();
      for (int i = nb - 1; i >= 0; --i) {
        if (in_sub(i)) {
          const T mi = mass[i];
          const T* ci = cg + 3 * i;
          const T* Ici = Icg + 9 * i;
          const M6<T> Vi = ld6(Vg + 6 * i), Ai = ld6(Ag + 6 * i);
          const M6<T> Pi = ld6(Pg + 6 * i), IAi = ld6(IAg + 6 * i);
          const M6<T> dVq = crm(Sj, Vi - Bj);
          const M6<T> dAv = t1j + crm(Sj, Vi - Vpar);
          M6<T> dfq = crf(Sj, IAi) + inertia(mi, ci, Ici, ld6s(Xl + 6 * i * LW, LW) - crm(Sj, Ai)) +
                      crf(dVq, Pi) +
                      crf(Vi, crf(Sj, Pi) + inertia(mi, ci, Ici, dVq - crm(Sj, Vi)));
          if (P.fm != nullptr) {
            for (int ci2 = 0; ci2 < nc; ++ci2) {
              if (contact_body[ci2] != i) continue;
              const V3<T> pc = ld3(pg + 3 * ci2);
              const V3<T> Jt = Sj.v + cross(Sj.w, pc);
              dfq.w = dfq.w - cross(Jt, ld3(fmg + 3 * ci2));
            }
          }
          M6<T> dfv = inertia(mi, ci, Ici, dAv) + crf(Sj, Pi) + crf(Vi, inertia(mi, ci, Ici, Sj));
          for (int ch = first_child[i]; ch >= 0; ch = next_sibling[ch]) {
            dfq = dfq + ld6s(Xl + 6 * ch * LW, LW);
            dfv = dfv + ld6s(Yl + 6 * ch * LW, LW);
          }
          st6s(Xl + 6 * i * LW, LW, dfq);
          st6s(Yl + 6 * i * LW, LW, dfv);
          const M6<T> Fi = ld6(Fg + 6 * i);
          for (int m = vfirst[i]; m < vfirst[i] + ndof[i]; ++m) {
            const M6<T> Sm = ld6(Sg + 6 * m);
            const bool cs = i != bj || (basej && dof_base[m] != 0);
            DT[m * LW + lane] = dot(Sm, dfq) + (cs ? dot(crm(Sj, Sm), Fi) : T(0));
            DT[(nv + m) * LW + lane] = dot(Sm, dfv);
          }
          if (i == bj) {
            dFq_bj = dfq;
            dFv_bj = dfv;
          }
        } else if (i < bj && ((static_cast<unsigned>(anc[bj]) >> i) & 1u)) {
          // an ancestor of body(j): its subtree sum is that of body(j)
          for (int m = vfirst[i]; m < vfirst[i] + ndof[i]; ++m) {
            const M6<T> Sm = ld6(Sg + 6 * m);
            DT[m * LW + lane] = dot(Sm, dFq_bj);
            DT[(nv + m) * LW + lane] = dot(Sm, dFv_bj);
          }
        }
      }
    }
  }

  // ---- dtau out of DT, lanes on consecutive addresses
  if (has_F) {
    __syncwarp();
    const int nn = nv * nv;
    T* outq = P.dtau_q + stage0 * nn;
    T* outv = P.dtau_v + stage0 * nn;
    for (int e = lane; e < count * nn; e += kWarp) {
      const int gs = e / nn, r = e % nn, m = r / nv, j = r % nv;
      outq[e] = DT[m * LW + gs * nv + j];
      outv[e] = DT[(nv + m) * LW + gs * nv + j];
    }
  }
}

template <typename T>
int launch(const Params<T>& in, void* stream_) {
  Params<T> P = in;
  if (P.stages <= 0) return 0;
  if (P.nv < 1 || P.nv > 32 || P.nb < 1 || P.nb > 32 || P.nc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  P.groups = kWarp / P.nv;
  const size_t head = head_bytes(P.nb, P.nv, P.nc, sizeof(T));
  const size_t per_warp = static_cast<size_t>(warp_numbers(P.nb, P.nv, P.nc, P.groups)) * sizeof(T);
  // two blocks' worth of shared memory on an SM (227 KB), up to 8 warps a block
  const size_t budget = 113 * 1024;
  int warps = budget > head ? static_cast<int>((budget - head) / per_warp) : 0;
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  P.warps = warps;
  const size_t bytes = head + warps * per_warp;
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        id_derivatives_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_block = static_cast<long long>(warps) * P.groups;
  const long long blocks = (P.stages + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  id_derivatives_kernel<T><<<static_cast<unsigned>(blocks), warps * kWarp, bytes,
                             static_cast<cudaStream_t>(stream_)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const int* topo, int nb, int nv, int nc, long long stages, const void* S,
          const void* v, const void* a, const void* c, const void* Ic, const void* mass,
          const void* gravity, const void* F, const void* p, const void* fm, void* dtau_q,
          void* dtau_v, void* dvel_q, void* dvel_v, void* dacc_q, void* dacc_v, void* stream) {
  Params<T> P;
  P.topo = topo;
  P.nb = nb; P.nv = nv; P.nc = nc;
  P.stages = stages;
  P.groups = 1; P.warps = 1;
  P.S = static_cast<const T*>(S);
  P.v = static_cast<const T*>(v);
  P.a = static_cast<const T*>(a);
  P.c = static_cast<const T*>(c);
  P.Ic = static_cast<const T*>(Ic);
  P.mass = static_cast<const T*>(mass);
  P.gravity = static_cast<const T*>(gravity);
  P.F = static_cast<const T*>(F);
  P.p = static_cast<const T*>(p);
  P.fm = static_cast<const T*>(fm);
  P.dtau_q = static_cast<T*>(dtau_q);
  P.dtau_v = static_cast<T*>(dtau_v);
  P.dvel_q = static_cast<T*>(dvel_q);
  P.dvel_v = static_cast<T*>(dvel_v);
  P.dacc_q = static_cast<T*>(dacc_q);
  P.dacc_v = static_cast<T*>(dacc_v);
  return launch<T>(P, stream);
}

}  // namespace

#define ID_DERIVATIVES_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const int* topo, int nb, int nv, int nc, long long stages,             \
                      const void* S, const void* v, const void* a, const void* c,            \
                      const void* Ic, const void* mass, const void* gravity, const void* F,  \
                      const void* p, const void* fm, void* dtau_q, void* dtau_v,             \
                      void* dvel_q, void* dvel_v, void* dacc_q, void* dacc_v,                \
                      void* stream) {                                                        \
    return entry<T>(topo, nb, nv, nc, stages, S, v, a, c, Ic, mass, gravity, F, p, fm,       \
                    dtau_q, dtau_v, dvel_q, dvel_v, dacc_q, dacc_v, stream);                 \
  }

ID_DERIVATIVES_ENTRY(id_derivatives_f32, float)
ID_DERIVATIVES_ENTRY(id_derivatives_f64, double)
