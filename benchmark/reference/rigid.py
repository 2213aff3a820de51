"""A plain rigid-body model for the reference: URDF reading, configuration
arithmetic, kinematics and inverse dynamics by the classical Newton-Euler
recursion in the world frame (vectors, not spatial algebra).

Configuration: a floating base is (p, quat) first, the quaternion scalar
first, then one angle per revolute joint in the URDF's depth-first order. The
tangent and velocity of the base are its body twist, angular first; the base
acceleration is the time derivative of that twist. Fixed joints merge a link
into its parent body. Every function takes any leading dims.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import torch

from . import lie

GRAVITY = (0.0, 0.0, -9.81)


def cross(a, b):
    """a x b over the last axis (broadcasting), in plain products."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _rpy(rpy):
    r, p, y = rpy
    Rx = np.array([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]])
    Ry = np.array([[np.cos(p), 0, np.sin(p)], [0, 1, 0], [-np.sin(p), 0, np.cos(p)]])
    Rz = np.array([[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _origin(el):
    if el is None:
        return np.zeros(3), np.eye(3)
    xyz = np.array([float(x) for x in el.get("xyz", "0 0 0").split()])
    rpy = np.array([float(x) for x in el.get("rpy", "0 0 0").split()])
    return xyz, _rpy(rpy)


@dataclasses.dataclass
class Body:
    parent: int            # -1: the world
    R0: np.ndarray         # joint frame in the parent body's frame
    p0: np.ndarray
    axis: np.ndarray       # revolute axis in the joint frame; None: free
    mass: float = 0.0
    first_moment: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    inertia_o: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((3, 3)))
    limits: tuple = (-np.inf, np.inf, np.inf, np.inf)   # q lo, q hi, v, effort

    def add_link(self, mass, com, I_com):
        """Merge a link's inertia given in this body's frame (about the
        body's origin: mass, first moment, rotational inertia)."""
        self.mass += mass
        self.first_moment = self.first_moment + mass * com
        self.inertia_o = self.inertia_o + I_com + mass * (
            com @ com * np.eye(3) - np.outer(com, com))


class Model:
    """Bodies in topological order and named frames (body, R, p)."""

    def __init__(self, path, floating, dtype=torch.float64, device="cpu"):
        root = ET.parse(path).getroot()
        links = {l.get("name"): l for l in root.findall("link")}
        kids, has_parent = {}, set()
        for j in root.findall("joint"):
            kids.setdefault(j.find("parent").get("link"), []).append(j)
            has_parent.add(j.find("child").get("link"))
        (root_link,) = [n for n in links if n not in has_parent]
        self.bodies, self.frames = [], {}
        self.floating = floating

        def inertial(name):
            el = links[name].find("inertial")
            if el is None:
                return 0.0, np.zeros(3), np.zeros((3, 3))
            c, R = _origin(el.find("origin"))
            ie = el.find("inertia")
            g = lambda k: float(ie.get(k, "0"))
            I = np.array([[g("ixx"), g("ixy"), g("ixz")],
                          [g("ixy"), g("iyy"), g("iyz")],
                          [g("ixz"), g("iyz"), g("izz")]])
            return float(el.find("mass").get("value")), c, R @ I @ R.T

        def walk(link, body, R, p):
            """`link` sits at (R, p) in the frame of `body`."""
            self.frames[link] = (body, R, p)
            if body >= 0:
                m, c, I = inertial(link)
                self.bodies[body].add_link(m, p + R @ c, R @ I @ R.T)
            for j in kids.get(link, []):
                child = j.find("child").get("link")
                jp, jR = _origin(j.find("origin"))
                cp, cR = p + R @ jp, R @ jR
                if j.get("type") == "fixed":
                    walk(child, body, cR, cp)
                    continue
                if j.get("type") not in ("revolute", "continuous"):
                    raise ValueError(f"joint type {j.get('type')} not covered")
                ax = j.find("axis")
                axis = np.array([float(x) for x in ax.get("xyz").split()]) \
                    if ax is not None else np.array([1.0, 0.0, 0.0])
                lim = j.find("limit")
                get = lambda k, d: d if lim is None or lim.get(k) is None \
                    else float(lim.get(k))
                lims = (get("lower", -np.inf), get("upper", np.inf),
                        get("velocity", np.inf), get("effort", np.inf))
                if j.get("type") == "continuous":
                    lims = (-np.inf, np.inf) + lims[2:]
                self.bodies.append(Body(body, cR, cp, axis / np.linalg.norm(axis),
                                        limits=lims))
                walk(child, len(self.bodies) - 1, np.eye(3), np.zeros(3))

        if floating:
            self.bodies.append(Body(-1, np.eye(3), np.zeros(3), None))
            walk(root_link, 0, np.eye(3), np.zeros(3))
        else:
            walk(root_link, -1, np.eye(3), np.zeros(3))
        self.kw = dict(dtype=dtype, device=device)
        t = lambda x: torch.as_tensor(np.asarray(x, float), **self.kw)
        self.joints = [i for i, b in enumerate(self.bodies) if b.axis is not None]
        self.nj = len(self.joints)
        self.nv = self.nj + (6 if floating else 0)
        self.nq = self.nj + (7 if floating else 0)
        self.nu = self.nj
        self.mass = t([b.mass for b in self.bodies])
        self.mc = t([b.first_moment for b in self.bodies])
        self.Io = t([b.inertia_o for b in self.bodies])
        self.R0 = t([b.R0 for b in self.bodies])
        self.p0 = t([b.p0 for b in self.bodies])
        self.axis = t([b.axis if b.axis is not None else np.zeros(3)
                       for b in self.bodies])
        lim = np.array([self.bodies[i].limits for i in self.joints])
        self.q_lo, self.q_hi = t(lim[:, 0]), t(lim[:, 1])
        self.v_max, self.u_max = t(lim[:, 2]), t(lim[:, 3])
        self.gravity = t(GRAVITY)
        K = lie.hat(self.axis)
        self.K1, self.K2 = K, K @ K
        self.total_mass = float(sum(b.mass for b in self.bodies))

    # ------------------------------------------------------------------
    def integrate(self, q, dq):
        if not self.floating:
            return q + dq
        qe, pe = lie.se3_exp(dq[..., :6])
        quat, p = lie.pose_compose(q[..., 3:7], q[..., :3], qe, pe)
        quat = quat / quat.norm(dim=-1, keepdim=True)
        return torch.cat([p, quat, q[..., 7:] + dq[..., 6:]], -1)

    def difference(self, q0, q1):
        """q1 (-) q0: the tangent that takes q0 to q1."""
        if not self.floating:
            return q1 - q0
        qi, pi = lie.pose_inverse(q0[..., 3:7], q0[..., :3])
        qd, pd = lie.pose_compose(qi, pi, q1[..., 3:7], q1[..., :3])
        return torch.cat([lie.se3_log(qd, pd), q1[..., 7:] - q0[..., 7:]], -1)

    # ------------------------------------------------------------------
    def _levels(self):
        """Bodies grouped by depth, each level's constants stacked: the
        recursions below step a whole level at once."""
        if hasattr(self, "_lv"):
            return self._lv
        depth = []
        for b in self.bodies:
            depth.append(0 if b.parent < 0 else depth[b.parent] + 1)
        levels = [[i for i, d in enumerate(depth) if d == k]
                  for k in range(max(depth) + 1)]
        where = {}
        for k, lv in enumerate(levels):
            for j, i in enumerate(lv):
                where[i] = (k, j)
        off, qoff = (6, 7) if self.floating else (0, 0)
        dev = self.kw["device"]
        out = []
        for k, lv in enumerate(levels):
            e = dict(bodies=lv)
            if self.bodies[lv[0]].axis is None:
                out.append(e)
                continue
            idx = torch.as_tensor(lv, device=dev)
            joint = [self.joints.index(i) for i in lv]
            e["qi"] = torch.as_tensor([qoff + j for j in joint], device=dev)
            e["vi"] = torch.as_tensor([off + j for j in joint], device=dev)
            for name in ("R0", "p0", "axis", "K1", "K2", "mass", "mc", "Io"):
                e[name] = getattr(self, name)[idx]
            parents = [self.bodies[i].parent for i in lv]
            if parents[0] >= 0:
                prev = levels[k - 1]
                e["parent"] = torch.as_tensor([prev.index(i) for i in parents],
                                              device=dev)
                # children -> parent sums as one product
                C = torch.zeros(len(prev), len(lv), **self.kw)
                for j, i in enumerate(parents):
                    C[prev.index(i), j] = 1.0
                e["to_parent"] = C
            out.append(e)
        self._lv, self._where = out, where
        return out

    def kinematics(self, q, v, a):
        """World (R, p, omega, vel, alpha, acc) of every body origin, one
        stack per level of the tree; acc is the classical acceleration, no
        gravity. Index a body with ``body_of``."""
        lead = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1], a.shape[:-1])
        q, v, a = (x.expand(lead + x.shape[-1:]) for x in (q, v, a))
        out = []
        for e in self._levels():
            if "qi" not in e:        # the floating base, a level of one
                Rb = lie.quat_matrix(q[..., 3:7])
                wl, vl = v[..., :3], v[..., 3:6]
                out.append(tuple(x[..., None, :] if x.dim() == len(lead) + 1
                                 else x[..., None, :, :] for x in (
                    Rb, q[..., :3], lie.mv(Rb, wl), lie.mv(Rb, vl),
                    lie.mv(Rb, a[..., :3]), lie.mv(Rb, a[..., 3:6] + cross(wl, vl)))))
                continue
            k = len(e["bodies"])
            qi, vi, ai = (x.index_select(-1, e[n])[..., None]
                          for x, n in ((q, "qi"), (v, "vi"), (a, "vi")))
            if "parent" in e:
                P = [x.index_select(-3 if x.dim() == len(lead) + 3 else -2,
                                    e["parent"]) for x in out[-1]]
                RP, pP, wP, velP, alP, accP = P
            else:
                RP = torch.eye(3, **self.kw).expand(lead + (k, 3, 3))
                pP = wP = velP = alP = accP = torch.zeros(lead + (k, 3), **self.kw)
                pP = pP.clone()
            s, c = torch.sin(qi)[..., None], torch.cos(qi)[..., None]
            Rq = torch.eye(3, **self.kw) + s * e["K1"] + (1 - c) * e["K2"]
            Rj = RP @ e["R0"] @ Rq
            pj = pP + lie.mv(RP, e["p0"])
            ax = lie.mv(Rj, e["axis"])
            r = pj - pP
            out.append((Rj, pj, wP + ax * vi, velP + cross(wP, r),
                        alP + ax * ai + cross(wP, ax * vi),
                        accP + cross(alP, r) + cross(wP, cross(wP, r))))
        return out

    def body_of(self, kin, b):
        """(R, p, omega, vel, alpha, acc) of body b from ``kinematics``."""
        self._levels()
        k, j = self._where[b]
        return tuple(x[..., j, :, :] if x.dim() >= 2 and x.shape[-2:] == (3, 3)
                     and i == 0 else x[..., j, :] for i, x in enumerate(kin[k]))

    def point(self, kin, frame):
        """World position, velocity and classical acceleration of a frame's
        origin."""
        b, _, off = self.frames[frame]
        R, p, w, vel, al, acc = self.body_of(kin, b)
        r = lie.mv(R, torch.as_tensor(off, **self.kw))
        return (p + r, vel + cross(w, r),
                acc + cross(al, r) + cross(w, cross(w, r)))

    def inverse_dynamics(self, q, v, a, forces=(), gravity=True, kin=None):
        """Generalized forces; ``forces`` are (frame, world force) pairs
        acting on the robot at the frames' origins. ``kin``: the kinematics
        at (q, v, a) where the caller has them."""
        kin = self.kinematics(q, v, a) if kin is None else kin
        levels = self._levels()
        g = self.gravity if gravity else torch.zeros(3, **self.kw)
        fs, ns = [], []
        for e, (R, p, w, vel, al, acc) in zip(levels, kin):
            if "qi" in e:
                mass, mc, Io = e["mass"], e["mc"], e["Io"]
            else:
                mass, mc, Io = self.mass[:1], self.mc[:1], self.Io[:1]
            c = lie.mv(R, mc)                         # mass times com offset
            I = R @ Io @ R.mT                         # about the body origin
            ag = acc - g
            # momentum rate of each body about its origin
            fs.append(mass[:, None] * ag + cross(al, c) + cross(w, cross(w, c)))
            ns.append(lie.mv(I, al) + cross(w, lie.mv(I, w)) + cross(c, ag))
        for frame, fw in forces:
            b, _, off = self.frames[frame]
            k, j = self._where[b]
            R = kin[k][0][..., j, :, :]
            r = lie.mv(R, torch.as_tensor(off, **self.kw))
            sel = torch.zeros(len(levels[k]["bodies"]), 1, **self.kw)
            sel[j] = 1.0
            fs[k] = fs[k] - sel * fw[..., None, :]
            ns[k] = ns[k] - sel * cross(r, fw)[..., None, :]
        taus = [None] * len(levels)
        for k in reversed(range(len(levels))):
            e = levels[k]
            R, p = kin[k][0], kin[k][1]
            if "qi" not in e:
                taus[k] = torch.cat([lie.mv(R[..., 0, :, :].mT, ns[k][..., 0, :]),
                                     lie.mv(R[..., 0, :, :].mT, fs[k][..., 0, :])], -1)
            else:
                taus[k] = (lie.mv(R, e["axis"]) * ns[k]).sum(-1)
            if "to_parent" in e:
                r = p - kin[k - 1][1].index_select(-2, e["parent"])
                C = e["to_parent"]
                fs[k - 1] = fs[k - 1] + C @ fs[k]
                ns[k - 1] = ns[k - 1] + C @ (ns[k] + cross(r, fs[k]))
        # joint order: the base, then the revolute joints in body order
        if not hasattr(self, "_perm"):
            order = [i for e in levels if "qi" in e for i in e["bodies"]]
            self._perm = torch.as_tensor(
                [order.index(i) for i in self.joints], device=self.kw["device"])
        joints = torch.cat([t for t, e in zip(taus, levels) if "qi" in e], -1)
        joints = joints.index_select(-1, self._perm)
        return torch.cat([taus[0], joints], -1) if self.floating else joints

    def mass_matrix(self, q):
        eye = torch.eye(self.nv, **self.kw)
        lead = q.shape[:-1]
        Z = torch.zeros(lead + (1, self.nv), **self.kw)
        cols = self.inverse_dynamics(q[..., None, :], Z, eye, gravity=False)
        return cols.mT                              # column j: M e_j

    def point_jacobians(self, q, frames):
        """(..., 3 len(frames), nv): velocities of the frames' origins per
        unit velocity, stacked."""
        eye = torch.eye(self.nv, **self.kw)
        kin = self.kinematics(q[..., None, :], eye, torch.zeros_like(eye))
        return torch.cat([self.point(kin, f)[1].mT for f in frames], -2)

    def positions(self, q, frames):
        """(..., len(frames), 3) world positions of the frames' origins."""
        z = torch.zeros(q.shape[:-1] + (self.nv,), **self.kw)
        kin = self.kinematics(q, z, z)
        return torch.stack([self.point(kin, f)[0] for f in frames], -2)
