"""The plain reference of one warm-started Newton update of the multiple-
shooting optimal control problem that the benchmark's configurations state.

It is written from the problem's definition, not from the solver under test:
every stage's residuals are plain functions of the perturbed iterate (the
configuration moved along the tangent, everything else added to), their
Jacobians come from forward-mode automatic differentiation, and the Newton
system of the whole horizon is assembled as ONE dense saddle-point matrix per
scenario and solved by LU with a step of iterative refinement. No condensing,
no Riccati recursion, no closed-form derivative.

The problem per scenario, stages k = 0..N-1 and the terminal state N:
  variables      x_k = (q_k, v_k), w_k = (a_k, f_k, u_k)
  cost           sum_k 1/2 |r_k|^2 + 1/2 |r_N|^2 (residuals weighted by
                 sqrt(dt w)); Gauss-Newton Hessian J^T J
  dynamics       ID(q, v+, a, f) - (0, u) = 0 and, per contact, the
                 Baumgarte row acc + kd vel + kp (pos - ref) = 0 on an active
                 contact, f = 0 on an inactive one; v+ is the post-impact
                 velocity of a stage that starts with an impulse:
                 M (v+ - v) = Jm^T Lambda, Jm v+ = 0 over the impacting feet
  state          q_{k+1} (-) (q_k (+) dt (v+ + dt a)) = 0 (as
                 difference(q_{k+1}, qp)), v+ + dt a - v_{k+1} = 0
  switching      the touching-down feet's positions at qp equal the planned
                 footholds on the stage before an impulse
  initial        x_0 = the measured state
  inequalities   g(z) <= 0 with slack s and dual nu: barrier mu, the Newton
                 step of (g + s = 0, s nu = mu) condensed into the Hessian,
                 fraction to the boundary 0.995, a trust cap on max|dx| or a
                 filter line search on a grid of halved steps.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.autograd.forward_ad as fwAD

from . import rigid


@dataclasses.dataclass
class Spec:
    """What the configuration states, in the reference's own terms."""
    model: rigid.Model
    T: float
    N: int
    weights: dict            # q, v, a, u, qf, vf: (nv,) / (nu,) tensors
    q_ref: torch.Tensor      # (nq,)
    constraints: tuple       # names, in the order of the slack dicts
    feet: tuple = ()         # contact frame names; () for a fixed base
    kp: float = 0.0
    kd: float = 0.0
    mu_friction: float = 0.7
    barrier: float = 1e-3
    tau: float = 0.995
    min_slack: float = 1e-4
    max_step: float = math.inf
    line_search: bool = False
    trials: int = 8
    filter_size: int = 8
    margin: float = 1e-8
    gamma: float = 1e-5

    @property
    def nc(self):
        return len(self.feet)

    @property
    def nf(self):
        return 3 * self.nc

    @property
    def nv(self):
        return self.model.nv

    @property
    def nu(self):
        return self.model.nu

    @property
    def nx(self):
        return 2 * self.nv

    @property
    def nw(self):
        return self.nv + self.nf + self.nu

    def dims(self):
        """(name, rows, terminal) per inequality component."""
        out = []
        for name in self.constraints:
            rows = self.nc if name == "friction_cone" else self.nu
            out.append((name, rows, name.startswith(("q_", "v_"))))
        return out


def _inequalities(spec, q, v, a, f, u, active):
    """Stacked g(z) of the components (each row <= 0 when feasible)."""
    m = spec.model
    parts = []
    for name in spec.constraints:
        if name == "u_lower":
            parts.append(-u - m.u_max)
        elif name == "u_upper":
            parts.append(u - m.u_max)
        elif name == "q_lower":
            parts.append(m.q_lo - q[..., m.nq - m.nj:])
        elif name == "q_upper":
            parts.append(q[..., m.nq - m.nj:] - m.q_hi)
        elif name == "v_lower":
            parts.append(-v[..., m.nv - m.nj:] - m.v_max)
        elif name == "v_upper":
            parts.append(v[..., m.nv - m.nj:] - m.v_max)
        elif name == "friction_cone":
            fc = f.reshape(f.shape[:-1] + (spec.nc, 3))
            cone = fc[..., 0] ** 2 + fc[..., 1] ** 2 \
                - spec.mu_friction ** 2 * fc[..., 2] ** 2
            parts.append(torch.where(active > 0.5, cone, -torch.ones_like(cone)))
        else:
            raise ValueError(f"unknown constraint {name}")
    if not parts:       # no inequality: an empty (..., 0) block
        return u[..., :0]
    return torch.cat(parts, -1)


def _feet(spec, kin):
    pts = [spec.model.point(kin, name) for name in spec.feet]
    return [torch.stack([p[i] for p in pts], -2) for i in range(3)]


def post_impact(spec, q, v, imp):
    """(v+, Lambda) of an impact on the feet with imp = 1."""
    M = spec.model.mass_matrix(q)
    J = spec.model.point_jacobians(q, spec.feet)
    m3 = imp.repeat_interleave(3, -1)
    Jm = m3[..., :, None] * J
    nv, nf = spec.nv, spec.nf
    top = torch.cat([M, -Jm.mT], -1)
    bot = torch.cat([Jm, torch.diag_embed(1.0 - m3)], -1)
    K = torch.cat([top, bot], -2)
    rhs = torch.cat([torch.zeros_like(v), -(Jm @ v[..., None])[..., 0]], -1)
    sol = torch.linalg.solve(K, rhs)
    return v + sol[..., :nv], sol[..., nv:]


def stage_residuals(spec, d, it):
    """Every stage quantity at the iterate moved by d (..., n_delta) =
    (dq, dv, da, df, du, dq', dv'): (..., m) with the blocks of
    ``stage_blocks``. ``it`` holds the iterate and the schedule per stage."""
    m, nv, nf, nu = spec.model, spec.nv, spec.nf, spec.nu
    o = 0

    def take(n):
        nonlocal o
        o += n
        return d[..., o - n:o]

    dq, dv, da, df, du, dqn, dvn = (take(nv), take(nv), take(nv), take(nf),
                                    take(nu), take(nv), take(nv))
    q = m.integrate(it["q"], dq)
    v, a, f, u = it["v"] + dv, it["a"] + da, it["f"] + df, it["u"] + du
    qn, vn = m.integrate(it["qn"], dqn), it["vn"] + dvn
    dt = it["dt"][..., None]
    v_eff = v
    rows = it.get("imp_rows")
    if rows is not None and rows.numel():
        v_plus = post_impact(spec, q[rows], v[rows], it["imp_contact"][rows])[0]
        v_eff = v.index_put((rows,), v_plus)
    w = spec.weights
    rc = torch.cat([(dt * w["q"]).sqrt() * m.difference(spec.q_ref, q),
                    (dt * w["v"]).sqrt() * v_eff, (dt * w["a"]).sqrt() * a,
                    (dt * w["u"]).sqrt() * u], -1)
    if spec.nc:
        act = it["active"]
        m3 = act.repeat_interleave(3, -1)
        fm = m3 * f
        forces = [(name, fm[..., 3 * i:3 * i + 3])
                  for i, name in enumerate(spec.feet)]
        kin = m.kinematics(q, v_eff, a)
        tau = m.inverse_dynamics(q, v_eff, a, forces, kin=kin)
        pos, vel, acc = _feet(spec, kin)
        baum = (acc + spec.kd * vel + spec.kp * (pos - it["ref"])).flatten(-2)
        e = torch.cat([tau - torch.cat([torch.zeros_like(tau[..., :nv - nu]), u], -1),
                       m3 * baum + (1.0 - m3) * f], -1)
    else:
        act = None
        e = m.inverse_dynamics(q, v_eff, a) - u
    qp = m.integrate(q, dt * (v_eff + dt * a))
    sq = m.difference(qn, qp)
    sv = v_eff + dt * a - vn
    parts = [rc, e, sq, sv]
    if spec.nc:
        pos_p = m.positions(qp, spec.feet)
        sw3 = it["sw"].repeat_interleave(3, -1)
        parts.append(sw3 * (pos_p - it["sw_pos"]).flatten(-2))
    parts.append(_inequalities(spec, q, v_eff, a, f, u, act))
    return torch.cat(parts, -1)


def stage_blocks(spec):
    nv, nf, nu = spec.nv, spec.nf, spec.nu
    ng = sum(r for _, r, _ in spec.dims())
    return dict(rc=3 * nv + nu, e=nv + nf, sq=nv, sv=nv, h=nf, g=ng)


def terminal_residuals(spec, d, it):
    """(r_N, g_N) at the terminal state moved by d (..., nx)."""
    m, nv = spec.model, spec.nv
    q = m.integrate(it["q"], d[..., :nv])
    v = it["v"] + d[..., nv:]
    w = spec.weights
    rc = torch.cat([w["qf"].sqrt() * m.difference(spec.q_ref, q),
                    w["vf"].sqrt() * v], -1)
    term = [(n, r) for n, r, t in spec.dims() if t]
    if term:
        sub = dataclasses.replace(spec, constraints=tuple(n for n, _ in term))
        z = torch.zeros(q.shape[:-1] + (spec.nu,), dtype=q.dtype, device=q.device)
        g = _inequalities(sub, q, v, None, None, z, None)
    else:
        g = rc[..., :0]
    return torch.cat([rc, g], -1)


def _split(x, sizes):
    out, o = {}, 0
    for k, n in sizes.items():
        out[k] = x[..., o:o + n]
        o += n
    return out


def _jac(fn, it, n):
    """(value (L, m), Jacobian (L, m, n)) of fn(d, it) at d = 0 by forward-
    mode differentiation: every row of ``it`` is repeated n times, the j-th
    copy carrying the unit tangent e_j, and all of them go through ONE
    evaluation with dual numbers."""
    L = it["q"].shape[0]
    like = it["q"]
    rep = {}
    for k, x in it.items():
        if k == "imp_rows":
            rep[k] = (x[:, None] * n + torch.arange(n, device=x.device)).reshape(-1)
        else:
            rep[k] = x.repeat_interleave(n, 0)
    eye = torch.eye(n, dtype=like.dtype, device=like.device).repeat(L, 1)
    with fwAD.dual_level():
        d = fwAD.make_dual(torch.zeros(L * n, n, dtype=like.dtype,
                                       device=like.device), eye)
        primal, tangent = fwAD.unpack_dual(fn(d, rep))
    return primal.reshape(L, n, -1)[:, 0], tangent.reshape(L, n, -1).mT


def _condense(g, s, nu, mu):
    """Per-row (sigma, rhs) of the barrier's Newton step folded into the
    Hessian and gradient."""
    eps = torch.finfo(s.dtype).eps
    r_p, r_c = g + s, s * nu - mu
    s_safe = torch.clamp(s, min=10 * eps)
    sigma = torch.clamp(nu / s_safe, max=0.1 / eps)
    rhs = nu + torch.clamp((nu * r_p - r_c) / s_safe, min=-0.1 / eps,
                           max=0.1 / eps)
    return sigma, rhs


def _ftb(x, dx, tau):
    if not x[0].numel():    # no inequality: the full step
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    ratio = torch.where(dx < 0, -tau * x / torch.where(dx < 0, dx, -torch.ones_like(dx)),
                        torch.ones_like(x))
    return ratio.flatten(1).amin(1)


class Reference:
    """The reference solver of one configuration; ``update`` is one Newton
    iteration of S scenarios at once."""

    def __init__(self, spec: Spec):
        self.spec = spec

    # -- warm start -----------------------------------------------------
    def warm_start(self, q0, v0, sched, scenarios, filter_on):
        """The constant warm start: q, v held, a = 0; with contacts the
        robot's weight over each stage's active feet and u from the inverse
        dynamics under those forces; slack and dual at feasibility. ``sched``
        is one scenario's schedule (its own numpy arrays)."""
        spec, m = self.spec, self.spec.model
        kw = m.kw
        N, S = spec.N, scenarios
        q = q0.expand(N + 1, m.nq).clone()
        v = v0.expand(N + 1, m.nv).clone()
        a = torch.zeros(N, m.nv, **kw)
        if spec.nc:
            act = torch.as_tensor(sched["active"], **kw)
            n_act = torch.clamp(act.sum(-1, keepdim=True), min=1)
            f = torch.zeros(N, spec.nc, 3, **kw)
            f[..., 2] = act * (m.total_mass * 9.81) / n_act
            f = f.reshape(N, spec.nf)
            forces = [(nm, f[:, 3 * i:3 * i + 3]) for i, nm in enumerate(spec.feet)]
            u = m.inverse_dynamics(q[:N], v[:N], a, forces)[:, m.nv - m.nu:]
        else:
            act = None
            f = torch.zeros(N, 0, **kw)
            u = torch.zeros(N, m.nu, **kw)
        zero_u = torch.zeros(m.nu, **kw)
        g_st = _inequalities(spec, q[:N], v[:N], a, f, u, act)
        g_t = _inequalities(spec, q[N], v[N], torch.zeros(m.nv, **kw),
                            torch.zeros(spec.nf, **kw), zero_u,
                            torch.zeros(spec.nc, **kw))
        g = torch.cat([g_st, g_t[None]], 0)
        slack = torch.clamp(-g, min=spec.min_slack)
        dual = spec.barrier / slack
        st = dict(q=q, v=v, a=a, f=f, u=u, slack=slack, dual=dual)
        st = {k: x[None].expand((S,) + x.shape).clone() for k, x in st.items()}
        F = spec.filter_size if filter_on else 0
        st["fc"] = torch.full((S, F), math.inf, **kw)
        st["fv"] = torch.full((S, F), math.inf, **kw)
        st["ptr"] = torch.zeros(S, dtype=torch.long, device=kw["device"])
        return st

    # -- one Newton iteration ---------------------------------------------
    def _indices(self, me, device):
        """Flat positions in the (ntot, ntot) saddle-point matrix of every
        block the update scatters there (built once)."""
        key = (me, str(device))
        if getattr(self, "_ix_key", None) == key:
            return self._ix
        spec, N = self.spec, self.spec.N
        nx, nw = spec.nx, spec.nw
        nz = (N + 1) * nx + N * nw
        ntot = nz + nx + N * me
        a = torch.arange
        cols = torch.stack([torch.cat([
            a(k * nx, (k + 1) * nx),
            a((N + 1) * nx + k * nw, (N + 1) * nx + (k + 1) * nw),
            a((k + 1) * nx, (k + 2) * nx)]) for k in range(N)])       # (N, nd)
        rows = nz + nx + a(N * me).reshape(N, me)                    # (N, me)
        cN = a(N * nx, (N + 1) * nx)
        r0, c0 = nz + a(nx), a(nx)
        flat = lambda r, c: (r * ntot + c).reshape(-1)
        ix = dict(
            H=flat(cols[:, :, None], cols[:, None, :]),
            A=flat(rows[:, :, None], cols[:, None, :]),
            AT=flat(cols[:, None, :], rows[:, :, None]),
            D=flat(rows, rows),
            HT=flat(cN[:, None], cN[None, :]),
            I0=torch.cat([flat(r0, c0), flat(c0, r0)]),
            l=cols.reshape(-1), lT=cN, b=rows.reshape(-1), b0=r0)
        self._ix = (nz, ntot, {k: v.to(device) for k, v in ix.items()})
        self._ix_key = key
        return self._ix

    def _stage_data(self, st, sched):
        spec, N = self.spec, self.spec.N
        S = st["q"].shape[0]
        flat = lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])
        it = dict(q=flat(st["q"][:, :N]), v=flat(st["v"][:, :N]), a=flat(st["a"]),
                  f=flat(st["f"]), u=flat(st["u"]), qn=flat(st["q"][:, 1:]),
                  vn=flat(st["v"][:, 1:]), dt=flat(sched["dt"]))
        if spec.nc:
            for k in ("active", "ref", "imp", "imp_contact", "sw", "sw_pos"):
                it[k] = flat(sched[k])
            it["imp_rows"] = torch.nonzero(it["imp"] > 0.5)[:, 0]
        return it

    def _values(self, st, sched, q_meas, v_meas, d_stage=None, d_term=None,
                slack=None):
        """(cost + barrier, L1 violation) per scenario at the iterate moved
        by the per-stage d (S, N, n_delta) and terminal d (S, nx)."""
        spec, N = self.spec, self.spec.N
        S = st["q"].shape[0]
        it = self._stage_data(st, sched)
        nd = 2 * spec.nx + spec.nw
        if d_stage is None:
            d_stage = torch.zeros(S, N, nd, **spec.model.kw)
            d_term = torch.zeros(S, spec.nx, **spec.model.kw)
        r = _split(stage_residuals(spec, d_stage.reshape(S * N, nd), it),
                   stage_blocks(spec))
        r = {k: x.reshape(S, N, -1) for k, x in r.items()}
        rt = terminal_residuals(spec, d_term, dict(q=st["q"][:, N], v=st["v"][:, N]))
        nrc = spec.nx
        cost = 0.5 * (r["rc"] ** 2).sum((1, 2)) + 0.5 * (rt[:, :nrc] ** 2).sum(1)
        slack = st["slack"] if slack is None else slack
        logs = -spec.barrier * torch.log(torch.clamp(slack, min=1e-30))
        tmask = self._terminal_mask(slack)
        barrier = logs[:, :N].sum((1, 2)) + (logs[:, N] * tmask).sum(1)
        relu = lambda x: torch.clamp(x, min=0.0)
        viol = sum(r[k].abs().sum((1, 2)) for k in ("e", "sq", "sv"))
        if spec.nc:
            viol = viol + r["h"].abs().sum((1, 2))
        viol = viol + relu(r["g"]).sum((1, 2)) + relu(rt[:, nrc:]).sum(1)
        q0 = spec.model.integrate(st["q"][:, 0], d_stage[:, 0, :spec.nv])
        v0 = st["v"][:, 0] + d_stage[:, 0, spec.nv:spec.nx]
        viol = viol + spec.model.difference(q0, q_meas).abs().sum(1) \
            + (v_meas - v0).abs().sum(1)
        return cost + barrier, viol

    def _terminal_mask(self, like):
        cols = []
        for _, rows, term in self.spec.dims():
            cols += [1.0 if term else 0.0] * rows
        return torch.as_tensor(cols, dtype=like.dtype, device=like.device)

    def update(self, st, q_meas, v_meas, sched):
        """One Newton iteration of every scenario; returns the new state."""
        spec, m, N = self.spec, self.spec.model, self.spec.N
        S = st["q"].shape[0]
        nv, nx, nw = spec.nv, spec.nx, spec.nw
        nd = nx + nw + nx
        kw = m.kw
        blocks = stage_blocks(spec)
        it = self._stage_data(st, sched)
        val, J = _jac(lambda d, r: stage_residuals(spec, d, r), it, nd)
        val = _split(val.reshape(S, N, -1), blocks)
        J = _split(J.reshape(S, N, J.shape[-2], nd).mT, blocks)
        J = {k: x.mT for k, x in J.items()}           # (S, N, rows, nd)
        tit = dict(q=st["q"][:, N], v=st["v"][:, N])
        tval, tJ = _jac(lambda d, r: terminal_residuals(spec, d, r), tit, nx)
        nrc = 2 * nv
        term_rows = tval.shape[-1] - nrc

        s_st, nu_st = st["slack"][:, :N], st["dual"][:, :N]
        sigma, rhs = _condense(val["g"], s_st, nu_st, spec.barrier)
        Jrc, Jg = J["rc"], J["g"]
        Hs = Jrc.mT @ Jrc + Jg.mT @ (sigma[..., None] * Jg)
        ls = (Jrc.mT @ val["rc"][..., None])[..., 0] + (Jg.mT @ rhs[..., None])[..., 0]
        tmask = self._terminal_mask(st["slack"]) > 0.5
        Ht = tJ[:, :nrc].mT @ tJ[:, :nrc]
        lt = (tJ[:, :nrc].mT @ tval[:, :nrc, None])[..., 0]
        if term_rows:
            gT = tval[:, nrc:]
            sT, nT = st["slack"][:, N][:, tmask], st["dual"][:, N][:, tmask]
            sgT, rhT = _condense(gT, sT, nT, spec.barrier)
            JgT = tJ[:, nrc:]
            Ht = Ht + JgT.mT @ (sgT[..., None] * JgT)
            lt = lt + (JgT.mT @ rhT[..., None])[..., 0]

        # dense saddle-point system: z = (x_0 .. x_N, w_0 .. w_{N-1}), then
        # the multipliers of x_0 = dx0 and of each stage's equalities
        eq_keys = ("e", "sq", "sv") + (("h",) if spec.nc else ())
        me = sum(blocks[k] for k in eq_keys)
        nz, ntot, ix = self._indices(me, kw["device"])
        dq0 = m.difference(st["q"][:, 0], q_meas)
        dx0 = torch.cat([dq0, v_meas - st["v"][:, 0]], -1)
        Aeq = torch.cat([J[key] for key in eq_keys], -2)          # (S, N, me, nd)
        beq = torch.cat([val[key] for key in eq_keys], -1)        # (S, N, me)
        diag = torch.ones(S, N, me, **kw)
        if spec.nc:   # a switching row that is off keeps its multiplier 0
            diag[..., me - spec.nf:] = 1.0 - sched["sw"].repeat_interleave(3, -1)
            diag[..., :me - spec.nf] = 0.0
        else:
            diag.zero_()
        Kd = torch.zeros(S, ntot * ntot, **kw)
        Kd.index_add_(1, ix["H"], Hs.reshape(S, -1))
        Kd.index_add_(1, ix["A"], Aeq.reshape(S, -1))
        Kd.index_add_(1, ix["AT"], Aeq.reshape(S, -1))
        Kd.index_add_(1, ix["D"], diag.reshape(S, -1))
        Kd.index_add_(1, ix["HT"], Ht.reshape(S, -1))
        Kd[:, ix["I0"]] = 1.0
        Kd = Kd.reshape(S, ntot, ntot)
        rhs_v = torch.zeros(S, ntot, **kw)
        rhs_v.index_add_(1, ix["l"], -ls.reshape(S, -1))
        rhs_v.index_add_(1, ix["lT"], -lt)
        rhs_v.index_add_(1, ix["b"], -beq.reshape(S, -1))
        rhs_v[:, ix["b0"]] = dx0
        # one LU per scenario (the libraries' batched LU is made for small
        # matrices), then a step of iterative refinement
        ys = []
        for i in range(S):
            LU, piv = torch.linalg.lu_factor(Kd[i])
            b = rhs_v[i, :, None]
            y = torch.linalg.lu_solve(LU, piv, b)
            ys.append(y + torch.linalg.lu_solve(LU, piv, b - Kd[i] @ y))
        z = torch.stack(ys)[..., 0]
        dX = z[:, :(N + 1) * nx].reshape(S, N + 1, nx)
        dW = z[:, (N + 1) * nx:nz].reshape(S, N, nw)
        d_stage = torch.cat([dX[:, :N], dW, dX[:, 1:]], -1)      # (S, N, nd)

        # slack and dual directions, fraction to the boundary
        dg = (Jg @ d_stage[..., None])[..., 0]
        ds = -(val["g"] + s_st) - dg
        dnu = -((s_st * nu_st - spec.barrier) + nu_st * ds) / s_st
        ds_t = torch.zeros_like(st["slack"][:, N])
        dnu_t = torch.zeros_like(st["dual"][:, N])
        if term_rows:
            dgT = (tJ[:, nrc:] @ dX[:, N, :, None])[..., 0]
            dsT = -(gT + sT) - dgT
            ds_t[:, tmask] = dsT
            dnu_t[:, tmask] = -((sT * nT - spec.barrier) + nT * dsT) / sT
        ds = torch.cat([ds, ds_t[:, None]], 1)
        dnu = torch.cat([dnu, dnu_t[:, None]], 1)
        ones = torch.ones(S, **kw)
        alpha_p = torch.minimum(ones, _ftb(st["slack"], ds, spec.tau))
        alpha_d = torch.minimum(ones, _ftb(st["dual"], dnu, spec.tau))
        if math.isfinite(spec.max_step):
            dmax = dX.abs().flatten(1).amax(1)
            alpha_p = torch.minimum(
                alpha_p, spec.max_step / torch.clamp(dmax, min=spec.max_step))
        eps = torch.finfo(st["q"].dtype).eps

        fc, fv, ptr = st["fc"], st["fv"], st["ptr"]
        if spec.line_search:
            cost0, viol0 = self._values(st, sched, q_meas, v_meas)
            K = spec.trials
            alphas = alpha_p[:, None] * 2.0 ** -torch.arange(K, **kw)
            rep = lambda x: x[:, None].expand((S, K) + x.shape[1:]).reshape(
                (S * K,) + x.shape[1:])
            st_k = {k: rep(x) for k, x in st.items() if k in ("q", "v", "a", "f", "u")}
            sch_k = {k: rep(x) for k, x in sched.items()}
            al = alphas.reshape(S * K)
            trial_slack = torch.clamp(rep(st["slack"]) + al[:, None, None] * rep(ds),
                                      min=eps)
            costs, viols = self._values(
                st_k, sch_k, rep(q_meas), rep(v_meas),
                al[:, None, None] * rep(d_stage), al[:, None] * rep(dX[:, N]),
                slack=trial_slack)
            costs, viols = costs.reshape(S, K), viols.reshape(S, K)
            g_, mg = spec.gamma, spec.margin

            def acceptable(c0, v0):
                return (costs[..., :, None] <= (c0 - g_ * v0 - mg)[..., None, :]) | \
                    (viols[..., :, None] <= ((1 - g_) * v0 - mg)[..., None, :])

            finite = torch.isfinite(costs) & torch.isfinite(viols)
            ok = finite & acceptable(cost0[:, None], viol0[:, None]).all(-1)
            if fc.shape[1]:
                ok = ok & acceptable(fc, fv).all(-1)
            any_ok = ok.any(-1)
            first = (torch.cumsum(ok.long(), -1) == 0).sum(-1)
            idx = torch.where(any_ok, first, torch.zeros_like(first))
            fallback = torch.where(finite[:, -1], alphas[:, -1],
                                   torch.zeros_like(alphas[:, -1]))
            chosen = alphas.gather(1, idx[:, None])[:, 0]
            alpha_p = torch.where(any_ok, chosen, fallback)
            cost_at = costs.gather(1, idx[:, None])[:, 0]
            by_cost = any_ok & (cost_at <= cost0 - g_ * viol0 - mg)
            insert = ~by_cost
            if fc.shape[1]:
                F = fc.shape[1]
                slot = (torch.arange(F, device=kw["device"]) == ptr[:, None]) \
                    & insert[:, None]
                fc = torch.where(slot, cost0[:, None], fc)
                fv = torch.where(slot, viol0[:, None], fv)
                ptr = torch.where(insert, (ptr + 1) % F, ptr)

        a3 = alpha_p[:, None, None]
        new = dict(st)
        new["q"] = m.integrate(st["q"], a3 * dX[..., :nv])
        new["v"] = st["v"] + a3 * dX[..., nv:]
        new["a"] = st["a"] + a3 * dW[..., :nv]
        new["f"] = st["f"] + a3 * dW[..., nv:nv + spec.nf]
        new["u"] = st["u"] + a3 * dW[..., nv + spec.nf:]
        new["slack"] = torch.clamp(st["slack"] + a3 * ds, min=eps)
        kappa = 0.01 / eps
        mu = spec.barrier
        new["dual"] = torch.minimum(
            torch.maximum(st["dual"] + alpha_d[:, None, None] * dnu,
                          mu / (kappa * new["slack"])),
            kappa * mu / new["slack"])
        new["fc"], new["fv"], new["ptr"] = fc, fv, ptr
        return new
