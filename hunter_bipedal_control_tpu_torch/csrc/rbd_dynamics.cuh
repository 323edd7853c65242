// One state's rigid-body dynamics on the compiled model, shared by B9
// (wbc_qp.cu, which also takes point_column_kin for a state kept apart from
// a State), B10 (momentum_observer.cu), B11 (sim_step.cu) and B13
// (sensing.cu): the kinematic chain of soa_model.cuh,
// every link CoM's and contact point's 16 Jacobian columns (v[3:6] are ZYX
// Euler rates, so the base columns carry E(theta)) with their time
// derivatives along v, and the mass matrix and nonlinear effects summed
// from them:
//   M = sum_k J_k' diag(m_k, I_k) J_k,
//   nle = sum_k J_k' [m_k (dJ_k v + g e_z); I_k dw_k + w_k x I_k w_k]
// (Newton-Euler at each link CoM in the Euler-rate coordinates: the same
// equations as the Lagrangian C v + g), and the links' momenta and their
// share of C(q, v)' v = sum_k dJ_k' h_k.  The entry of a joint that does not
// move a point is its column's value times 0 (the ancestor mask), so a NaN
// state spreads as it does in the plain versions.
#pragma once

#include "soa_model.cuh"

namespace {

constexpr int NQ = 6 + NJ;              // 16
constexpr int NF = 3 * NC;              // 12

// one state (measured or desired) and what the block derives from it
struct State {
  Kin k;
  float v[NQ];
  float E[9], Ed[9];        // E(theta) and dE/dt along theta_dot
  float Jl[L][NQ][3];       // link CoM Jacobians: linear, angular columns
  float Ja[L][NQ][3];
  float w[L][3];            // J v: angular velocity
  float wd[L][3], cdd[L][3];  // dJ/dt v: angular, CoM
  float pc[NC][3], vc[NC][3], ac[NC][3];  // contact points: p, J v, dJ/dt v
  float Jc[NF][NQ];         // contact Jacobians (linear rows)
};

__device__ __forceinline__ void euler_Edot(const float* trig, const float* thd, float* Ed) {
  const float cz = trig[0], sz = trig[1], cy = trig[2], sy = trig[3];
  const float zd = thd[0], yd = thd[1];
  Ed[0] = 0.0f; Ed[1] = -cz * zd; Ed[2] = -sz * zd * cy - cz * sy * yd;
  Ed[3] = 0.0f; Ed[4] = -sz * zd; Ed[5] = cz * zd * cy - sz * sy * yd;
  Ed[6] = 0.0f; Ed[7] = 0.0f;     Ed[8] = -cy * yd;
}

// ZYX Euler rates from a world angular velocity: E(zyx)^-1 om
__device__ void euler_rates_dev(const float* zyx, const float* om, float* rates) {
  const float cz = cosf(zyx[0]), sz = sinf(zyx[0]), cy = cosf(zyx[1]), sy = sinf(zyx[1]);
  const float ty = sy / cy;
  const float Einv[9] = {cz * ty, sz * ty, 1.0f, -sz, cz, 0.0f, cz / cy, sz / cy, 0.0f};
  mv3(Einv, om, rates);
}

// an rbd state [theta_zyx, p, qj, omega_world, p_dot, qj_dot] -> q and v in
// the Euler-rate form
__device__ void rbd_to_qv(const float* rbd, float* q, float* v) {
  for (int a = 0; a < 3; ++a) {
    q[a] = rbd[3 + a];
    q[3 + a] = rbd[a];
    v[a] = rbd[NQ + 3 + a];
  }
  for (int j = 0; j < NJ; ++j) {
    q[6 + j] = rbd[6 + j];
    v[6 + j] = rbd[NQ + 6 + j];
  }
  euler_rates_dev(rbd, rbd + NQ, v + 3);
}

// lane of the chain: FK of q, world inertias, the velocity pass of s->v,
// E(theta) and dE/dt
__device__ void state_chain(const float* K, const float* q, State* s) {
  fk_dev(K, q, &s->k);
  world_inertias_dev(K, &s->k);
  velocity_pass_dev(s->v, s->v + 6, &s->k);
  euler_E(s->k.trig, s->E);
  euler_Edot(s->k.trig, s->v + 3, s->Ed);
}

// column i of a point's Jacobian (linear lin, angular ang) and its time
// derivative (dlin, dang) for a point x with velocity xd on link k
__device__ void point_column(const State* s, int k, int i, const float* x, const float* xd,
                             float* lin, float* ang, float* dlin, float* dang) {
  const Kin* w = &s->k;
  if (i < 3) {
    for (int a = 0; a < 3; ++a) {
      lin[a] = a == i ? 1.0f : 0.0f;
      ang[a] = dlin[a] = dang[a] = 0.0f;
    }
  } else if (i < 6) {
    const int c = i - 3;
    const float Ec[3] = {s->E[c], s->E[3 + c], s->E[6 + c]};
    const float Edc[3] = {s->Ed[c], s->Ed[3 + c], s->Ed[6 + c]};
    float r[3], rd[3], t1[3], t2[3];
    for (int a = 0; a < 3; ++a) {
      r[a] = x[a] - w->p[0][a];
      rd[a] = xd[a] - s->v[a];
    }
    cross3(Ec, r, lin);
    cross3(Edc, r, t1);
    cross3(Ec, rd, t2);
    for (int a = 0; a < 3; ++a) {
      ang[a] = Ec[a];
      dlin[a] = t1[a] + t2[a];
      dang[a] = Edc[a];
    }
  } else {
    const int j = i - 6;
    const float mask = static_cast<float>(c_anc[k][j]);
    const float* aj = w->aw[j];
    float r[3], rd[3], ad[3], l[3], t1[3], t2[3];
    for (int a = 0; a < 3; ++a) {
      r[a] = x[a] - w->anchor[j][a];
      rd[a] = xd[a] - w->vo[c_child[j]][a];
    }
    cross3(w->om[c_parent[j]], aj, ad);
    cross3(aj, r, l);
    cross3(ad, r, t1);
    cross3(aj, rd, t2);
    for (int a = 0; a < 3; ++a) {
      lin[a] = l[a] * mask;
      ang[a] = aj[a] * mask;
      dlin[a] = (t1[a] + t2[a]) * mask;
      dang[a] = ad[a] * mask;
    }
  }
}

// point_column on one state's kinematics w, E, dE/dt and v kept apart from
// a State (B9), the point's link given by its ancestor bits (bit j: SOA_ANC's
// entry of joint j), which the lanes of a warp hold for different links
// without reading the constant bank at different addresses: the same
// arithmetic
__device__ __forceinline__ unsigned ancestor_bits(int k) {
  unsigned bits = 0;
  for (int j = 0; j < NJ; ++j) bits |= static_cast<unsigned>(c_anc[k][j] != 0) << j;
  return bits;
}

__device__ void point_column_kin(const Kin* w, const float* E, const float* Ed, const float* v,
                                 unsigned anc, int i, const float* x, const float* xd,
                                 float* lin, float* ang, float* dlin, float* dang) {
  if (i < 3) {
    for (int a = 0; a < 3; ++a) {
      lin[a] = a == i ? 1.0f : 0.0f;
      ang[a] = dlin[a] = dang[a] = 0.0f;
    }
  } else if (i < 6) {
    const int c = i - 3;
    const float Ec[3] = {E[c], E[3 + c], E[6 + c]};
    const float Edc[3] = {Ed[c], Ed[3 + c], Ed[6 + c]};
    float r[3], rd[3], t1[3], t2[3];
    for (int a = 0; a < 3; ++a) {
      r[a] = x[a] - w->p[0][a];
      rd[a] = xd[a] - v[a];
    }
    cross3(Ec, r, lin);
    cross3(Edc, r, t1);
    cross3(Ec, rd, t2);
    for (int a = 0; a < 3; ++a) {
      ang[a] = Ec[a];
      dlin[a] = t1[a] + t2[a];
      dang[a] = Edc[a];
    }
  } else {
    const int j = i - 6;
    const float mask = static_cast<float>((anc >> j) & 1u);
    const float* aj = w->aw[j];
    float r[3], rd[3], ad[3], l[3], t1[3], t2[3];
    for (int a = 0; a < 3; ++a) {
      r[a] = x[a] - w->anchor[j][a];
      rd[a] = xd[a] - w->vo[c_child[j]][a];
    }
    cross3(w->om[c_parent[j]], aj, ad);
    cross3(aj, r, l);
    cross3(ad, r, t1);
    cross3(aj, rd, t2);
    for (int a = 0; a < 3; ++a) {
      lin[a] = l[a] * mask;
      ang[a] = aj[a] * mask;
      dlin[a] = (t1[a] + t2[a]) * mask;
      dang[a] = ad[a] * mask;
    }
  }
}

// the velocity of a point x on link k, by the velocity pass
__device__ __forceinline__ void point_velocity(const Kin* w, int k, const float* x, float* xd) {
  float d[3], t[3];
  for (int a = 0; a < 3; ++a) d[a] = x[a] - w->p[k][a];
  cross3(w->om[k], d, t);
  for (int a = 0; a < 3; ++a) xd[a] = w->vo[k][a] + t[a];
}

// lane of phase 2: link k's CoM Jacobian (stored), its angular velocity
// J_ang v and dJ/dt v
__device__ void link_columns(State* s, int k) {
  const float* x = s->k.com[k];
  float xd[3];
  point_velocity(&s->k, k, x, xd);
  float w[3] = {0.0f, 0.0f, 0.0f}, wd[3] = {0.0f, 0.0f, 0.0f}, cdd[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < NQ; ++i) {
    float lin[3], ang[3], dlin[3], dang[3];
    point_column(s, k, i, x, xd, lin, ang, dlin, dang);
    const float vi = s->v[i];
    for (int a = 0; a < 3; ++a) {
      s->Jl[k][i][a] = lin[a];
      s->Ja[k][i][a] = ang[a];
      w[a] = w[a] + ang[a] * vi;
      cdd[a] = cdd[a] + dlin[a] * vi;
      wd[a] = wd[a] + dang[a] * vi;
    }
  }
  for (int a = 0; a < 3; ++a) {
    s->w[k][a] = w[a];
    s->wd[k][a] = wd[a];
    s->cdd[k][a] = cdd[a];
  }
}

// lane of phase 2: contact c's point, Jacobian (stored), J v and dJ/dt v
__device__ void contact_columns(const float* K, State* s, int c) {
  const int k = c_cparent[c];
  float x[3], xd[3], t[3];
  mv3(s->k.R[k], K + K_CPOS + 3 * c, t);
  for (int a = 0; a < 3; ++a) x[a] = s->k.p[k][a] + t[a];
  point_velocity(&s->k, k, x, xd);
  float vc[3] = {0.0f, 0.0f, 0.0f}, ac[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < NQ; ++i) {
    float lin[3], ang[3], dlin[3], dang[3];
    point_column(s, k, i, x, xd, lin, ang, dlin, dang);
    const float vi = s->v[i];
    for (int a = 0; a < 3; ++a) {
      s->Jc[3 * c + a][i] = lin[a];
      vc[a] = vc[a] + lin[a] * vi;
      ac[a] = ac[a] + dlin[a] * vi;
    }
  }
  for (int a = 0; a < 3; ++a) {
    s->pc[c][a] = x[a];
    s->vc[c][a] = vc[a];
    s->ac[c][a] = ac[a];
  }
}

// lane of a link: link k's wrench terms of nle, F = m_k (dJ_k v + g e_z)
// and T = I_k dw_k + w_k x I_k w_k (after link_columns)
__device__ void link_wrench(const float* K, const State* s, int k, float* F, float* T) {
  const float mk = K[K_MASS + k];
  float Iw_w[3], Iw_wd[3], wx[3];
  mv3(s->k.Iw[k], s->w[k], Iw_w);
  mv3(s->k.Iw[k], s->wd[k], Iw_wd);
  cross3(s->w[k], Iw_w, wx);
  for (int a = 0; a < 3; ++a) {
    F[a] = mk * (s->cdd[k][a] + (a == 2 ? GRAVITY : 0.0f));
    T[a] = Iw_wd[a] + wx[a];
  }
}

// link k's momentum at its CoM (after link_columns): the CoM's velocity cd,
// hl = m_k cd and ha = I_k w_k
__device__ void link_momentum(const float* K, const State* s, int k, float* cd, float* hl,
                              float* ha) {
  point_velocity(&s->k, k, s->k.com[k], cd);
  mv3(s->k.Iw[k], s->w[k], ha);
  const float mk = K[K_MASS + k];
  for (int a = 0; a < 3; ++a) hl[a] = mk * cd[a];
}

// link k's term of column i of sum_k dJ_k' h_k, which is C(q, v)' v (from
// Mdot = C + C' and C v = sum_k J_k' [m_k dJ_k v; I_k dw_k + w_k x I_k w_k]:
// Mdot v - C v = sum_k dJ_k' h_k); cd, hl, ha from link_momentum
__device__ float momentum_rate_term(const State* s, int k, int i, const float* cd,
                                    const float* hl, const float* ha) {
  float lin[3], ang[3], dlin[3], dang[3];
  point_column(s, k, i, s->k.com[k], cd, lin, ang, dlin, dang);
  return ((dlin[0] * hl[0] + dlin[1] * hl[1]) + dlin[2] * hl[2])
         + ((dang[0] * ha[0] + dang[1] * ha[1]) + dang[2] * ha[2]);
}

// M[i][j] over the links' columns
__device__ float mass_entry(const float* K, const State* s, int i, int j) {
  float lin = 0.0f, ang = 0.0f;
  for (int k = 0; k < L; ++k) {
    const float* li = s->Jl[k][i];
    const float* lj = s->Jl[k][j];
    const float* ai = s->Ja[k][i];
    float Ia[3];
    mv3(s->k.Iw[k], s->Ja[k][j], Ia);
    lin = lin + K[K_MASS + k] * ((li[0] * lj[0] + li[1] * lj[1]) + li[2] * lj[2]);
    ang = ang + ((ai[0] * Ia[0] + ai[1] * Ia[1]) + ai[2] * Ia[2]);
  }
  return lin + ang;
}

// nle[i] from the links' wrench terms F, T (L x 3)
__device__ float nle_entry(const State* s, const float (*F)[3], const float (*T)[3], int i) {
  float acc = 0.0f;
  for (int k = 0; k < L; ++k) {
    const float* li = s->Jl[k][i];
    const float* ai = s->Ja[k][i];
    acc = acc + (((li[0] * F[k][0] + li[1] * F[k][1]) + li[2] * F[k][2])
                 + ((ai[0] * T[k][0] + ai[1] * T[k][1]) + ai[2] * T[k][2]));
  }
  return acc;
}

}  // namespace
