"""SE(3) pose-graph optimization over the odometry chain and loop edges.

Port of ``ros_stereo_slam_tpu/models/pose_graph.py``: :func:`optimize`
runs Gauss-Newton with right-perturbation Jacobians (second-order inverse
right Jacobian), vertex 0 fixed, identity information, and the normal
equations solved by block-Jacobi-preconditioned conjugate gradient whose
matvec is an edge-wise gather and scatter; :class:`PoseGraph` is the
incremental graph of the online drivers, with g2o text I/O.  The solve
itself, :func:`gauss_newton`, runs on any layout of the vertex rows:
:func:`optimize` gives it all F rows and, with a mesh, sums its normal
equations over the ranks (the edge-sharded layout);
``PoseGraph.optimize(mesh=...)`` routes to the chain-sharded one
(:mod:`ros_stereo_slam_tpu_torch.parallel.dist_pgo`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PGOConfig

from ros_stereo_slam_tpu_torch.ops import linalg
from ros_stereo_slam_tpu_torch.parallel.mesh import (Mesh, all_gather, check_mesh, psum,
                                                     shard_bounds)
from ros_stereo_slam_tpu_torch.utils import lie, profiling


def _ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """Little adjoint of (..., 6) twists (rho, phi): [[phi^, rho^], [0, phi^]]."""
    ph = lie.hat_so3(xi[..., 3:])
    rh = lie.hat_so3(xi[..., :3])
    top = torch.cat([ph, rh], dim=-1)
    bot = torch.cat([torch.zeros_like(ph), ph], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jr_inv(r: torch.Tensor) -> torch.Tensor:
    """Second-order inverse right Jacobian of SE(3) at twists r (..., 6)."""
    ad = _ad_se3(r)
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    return eye + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


def _edge_residual_jacobians(Ti, Tj, Z):
    """r = log(Z^-1 Ti^-1 Tj) and the right-perturbation Jacobians (Ji, Jj)."""
    Tij = lie.inv_se3(Ti) @ Tj
    r = lie.log_se3(lie.inv_se3(Z) @ Tij)
    Jri = _jr_inv(r)
    return r, -Jri @ lie.adjoint_se3(lie.inv_se3(Tij)), Jri


def gauss_newton(T, odo_Z, loop_Z, w_o, w_l, ok, free, ends, scatter, dot,
                 iters: int, cg_iters: int, damping: float) -> torch.Tensor:
    """Gauss-Newton with block-Jacobi-preconditioned CG on one layout of the
    graph's vertex rows `T` (all F of them, or a rank's block).

    The layout comes as three functions: ``ends(x)`` gives x at the
    odometry edges' two ends and at the loop edges' two ends;
    ``scatter(ci, cj, cli, clj)`` adds the four per-edge terms onto the
    layout's vertex rows, summed over the ranks that share the graph;
    ``dot(a, b)`` is the whole inner product.  `w_o`/`w_l` weigh the
    edges, `ok` holds the (E, 1, 1) masks of the four ends' free vertices
    and `free` the rows' gauge mask.  The GN iterations and CG steps
    (neither stops early) go to the innermost open span's attributes.
    """
    dt, dev = T.dtype, T.device
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def jt(J, r):
        return torch.einsum("eab,ea->eb", J, r)

    def safe(v):
        return torch.where(v.abs() > 1e-20, v, torch.full_like(v, 1e-20))

    for _ in range(iters):
        T_prev, T_cur, T_li, T_lj = ends(T)
        r_o, Ji_o, Jj_o = _edge_residual_jacobians(T_prev, T_cur, odo_Z)
        r_l, Ji_l, Jj_l = _edge_residual_jacobians(T_li, T_lj, loop_Z)
        Ji_o = Ji_o * ok[0] * w_o[:, None, None]
        Jj_o = Jj_o * ok[1] * w_o[:, None, None]
        Ji_l = Ji_l * ok[2] * w_l[:, None, None]
        Jj_l = Jj_l * ok[3] * w_l[:, None, None]
        r_o_w = r_o * w_o[:, None]
        r_l_w = r_l * w_l[:, None]

        # right-hand side b = -sum J^T r, scattered per vertex
        b = scatter(-jt(Ji_o, r_o_w), -jt(Jj_o, r_o_w), -jt(Ji_l, r_l_w), -jt(Jj_l, r_l_w))
        # block diagonal of H for the Jacobi preconditioner
        D = scatter(*(torch.einsum("eab,eac->ebc", J, J) for J in (Ji_o, Jj_o, Ji_l, Jj_l)))
        D_inv = linalg.spd_inverse_small(D + (damping + 1e-8) * eye6)

        def hx(x):
            """H @ x by edge-wise gather and scatter."""
            x_prev, x_cur, x_li, x_lj = ends(x)
            t_o = (torch.einsum("eab,eb->ea", Ji_o, x_prev)
                   + torch.einsum("eab,eb->ea", Jj_o, x_cur))
            t_l = (torch.einsum("eab,eb->ea", Ji_l, x_li)
                   + torch.einsum("eab,eb->ea", Jj_l, x_lj))
            return scatter(jt(Ji_o, t_o), jt(Jj_o, t_o), jt(Ji_l, t_l),
                           jt(Jj_l, t_l)) + damping * x

        def precond(v):
            return torch.einsum("fab,fb->fa", D_inv, v)

        # preconditioned CG from x = 0
        x = torch.zeros(T.shape[:-2] + (6,), dtype=dt, device=dev)
        r = b - hx(x)
        z = precond(r)
        p = z
        rz = dot(r, z)
        for _ in range(cg_iters):
            Ap = hx(p)
            alpha = rz / safe(dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = dot(r, z)
            p = z + (rz_new / safe(rz)) * p
            rz = rz_new
        # right update: T <- T exp(x^)
        T = T @ lie.exp_se3(x * free[:, None])
    profiling.annotate(gn_iters=iters, cg_steps=iters * cg_iters)  # no early exit
    return T


def optimize(
    poses: torch.Tensor,  # (F, 4, 4) current estimates
    n_poses: int,  # number of valid poses
    odo_Z: torch.Tensor,  # (F, 4, 4); measurement of edge (idx-1 -> idx)
    loop_i: torch.Tensor,  # (L,) int edge endpoints
    loop_j: torch.Tensor,  # (L,)
    loop_Z: torch.Tensor,  # (L, 4, 4) loop measurements
    loop_valid: torch.Tensor,  # (L,) bool
    iters: int = 10,
    cg_iters: int = 64,
    damping: float = 1e-6,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Gauss-Newton over the pose chain; returns the optimized (F, 4, 4).

    With a `mesh` (:class:`~ros_stereo_slam_tpu_torch.parallel.mesh.Mesh`,
    the JAX function's ``axis_name``) every rank passes the same whole
    arrays and gets the same result (the EDGE-sharded layout): rank d
    takes the odometry edges of its block of F (F must divide by the mesh
    size), rank 0 alone the loop edges, the poses and CG vectors stay
    replicated, and each rank's share of b, of the block diagonal and of
    every ``H @ x`` is summed over the ranks.
    """
    check_mesh(mesh)
    F = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    vid = torch.arange(F, device=dev)
    idx = vid
    if mesh is not None:
        blk = shard_bounds(F, mesh, "poses")
        idx, odo_Z = vid[blk], odo_Z[blk]
        if mesh.rank != 0:
            loop_valid = torch.zeros_like(loop_valid)
    prev = torch.clamp(idx - 1, min=0)
    loop_i, loop_j = loop_i.to(torch.int64), loop_j.to(torch.int64)
    # Odometry edge e connects (e-1, e), valid for 1 <= e < n_poses.
    w_o = ((idx >= 1) & (idx < n_poses)).to(dt)
    w_l = loop_valid.to(dt)
    # Gauge: vertex 0 is constant (over poses, not edges).
    free = ((vid > 0) & (vid < n_poses)).to(dt)

    def vertex_ok(v):
        return ((v > 0) & (v < n_poses)).to(dt)[:, None, None]

    def ends(x):
        return x[prev], x if mesh is None else x[idx], x[loop_i], x[loop_j]

    def scatter(ci, cj, cli, clj):
        out = torch.zeros((F,) + ci.shape[1:], dtype=ci.dtype, device=dev)
        for rows, c in ((prev, ci), (idx, cj), (loop_i, cli), (loop_j, clj)):
            out.index_add_(0, rows, c)
        return out if mesh is None else psum(out, mesh)

    def dot(a, b):
        return (a * b).sum()

    ok = (vertex_ok(idx - 1), vertex_ok(idx), vertex_ok(loop_i), vertex_ok(loop_j))
    return gauss_newton(poses, odo_Z, loop_Z, w_o, w_l, ok, free, ends, scatter, dot,
                        iters, cg_iters, damping)


def chain_measurements(poses: torch.Tensor) -> torch.Tensor:
    """Odometry measurements of a trajectory: Z[i] = T_{i-1}^-1 T_i (Z[0] = I)."""
    prev = torch.cat([poses[:1], poses[:-1]], dim=0)
    return lie.inv_se3(prev) @ poses


def rewrite_points(
    points: torch.Tensor,  # (K, P, 3) keyframe cloud blocks (world frame)
    kf_frame_idx: torch.Tensor,  # (K,) pose index of each keyframe
    old_poses: torch.Tensor,  # (F, 4, 4)
    new_poses: torch.Tensor,  # (F, 4, 4)
) -> torch.Tensor:
    """Re-express keyframe clouds after PGO: p' = T_new T_old^-1 p."""
    fi = kf_frame_idx.to(torch.int64)
    delta = new_poses[fi] @ lie.inv_se3(old_poses[fi])
    return (torch.einsum("kij,kpj->kpi", delta[:, :3, :3], points)
            + delta[:, None, :3, 3])


_G2O_INFO = " ".join(["1 0 0 0 0 0", "1 0 0 0 0", "1 0 0 0", "1 0 0", "1 0", "1"])


def _g2o_fields(T: np.ndarray) -> list[str]:
    """(n, 4, 4) transforms -> "tx ty tz qx qy qz qw" per transform, each
    number printed as a float32."""
    T = np.asarray(T, dtype=np.float32)
    q = lie.quat_from_rot(torch.from_numpy(np.ascontiguousarray(T[:, :3, :3]))).numpy()
    t = T[:, :3, 3]
    return [f"{a[0]} {a[1]} {a[2]} {b[1]} {b[2]} {b[3]} {b[0]}" for a, b in zip(t, q)]


def _transforms_of(vals: list[list[float]]) -> np.ndarray:
    """Rows "tx ty tz qx qy qz qw" -> (n, 4, 4) float32 transforms."""
    v = np.asarray(vals, dtype=np.float32).reshape(-1, 7)
    q = torch.from_numpy(np.ascontiguousarray(v[:, [6, 3, 4, 5]]))
    T = np.tile(np.eye(4, dtype=np.float32), (v.shape[0], 1, 1))
    T[:, :3, :3] = lie.rot_from_quat(q).numpy()
    T[:, :3, 3] = v[:, :3]
    return T


@dataclass
class PoseGraph:
    """The incremental pose graph (the reference's ``globalPoseGraph``:
    initializeGraph / augmentNode / addLoopClosure / globalOptimize) with
    fixed-capacity tensors on `device`, written in place."""

    config: PGOConfig
    device: torch.device | str = "cuda"
    count: int = 0
    n_loops: int = 0
    last_path: str | None = None  # the layout of the last optimize: "single", "chain_sharded"

    def __post_init__(self):
        F, L = self.config.max_poses, self.config.max_loop_edges
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.odo_Z = eye.repeat(F, 1, 1)  # odo_Z[i]: edge (i - 1 -> i)
        self.loop_i = torch.zeros((L,), dtype=torch.int32, device=self.device)
        self.loop_j = torch.zeros((L,), dtype=torch.int32, device=self.device)
        self.loop_Z = eye.repeat(L, 1, 1)
        self.loop_valid = torch.zeros((L,), dtype=torch.bool, device=self.device)

    def _as_z(self, Z) -> torch.Tensor:
        return torch.as_tensor(Z, dtype=torch.float32).to(self.device)

    def initialize(self) -> None:
        self.count = 1  # vertex 0 at identity

    def add_odometry(self, Z) -> None:
        """Append vertex `count` with edge (count - 1 -> count); raises when
        the graph holds ``max_poses`` vertices."""
        self.add_odometry_batch(self._as_z(Z)[None])

    def add_odometry_batch(self, Z) -> None:
        """Append ``Z.shape[0]`` vertices, one edge each, in one write."""
        Z = self._as_z(Z)
        n = Z.shape[0]
        if self.count + n > self.config.max_poses:
            raise RuntimeError(f"pose-graph capacity exhausted ({self.config.max_poses} poses); "
                               "raise PGOConfig.max_poses")
        self.odo_Z[self.count:self.count + n] = Z
        self.count += n

    def add_loop(self, i: int, j: int, Z=None) -> None:
        """Loop edge i -> j; Z defaults to the identity (the reference's
        closure).  Raises when the edge store is full."""
        if self.n_loops >= self.loop_i.shape[0]:
            raise RuntimeError(f"loop-edge capacity exhausted ({self.loop_i.shape[0]}); "
                               "raise PGOConfig.max_loop_edges")
        s = self.n_loops
        self.loop_i[s] = int(i)
        self.loop_j[s] = int(j)
        if Z is not None:
            self.loop_Z[s] = self._as_z(Z)
        self.loop_valid[s] = True
        self.n_loops += 1

    def optimize(self, poses: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        """Global optimization of the (max_poses, 4, 4) `poses` (the
        reference's ``globalOptimize``); returns new poses.

        Under a `mesh` of more than one rank whose size divides max_poses,
        every rank (each must call this) solves its block of the chain
        (:func:`~ros_stereo_slam_tpu_torch.parallel.dist_pgo.
        optimize_chain_sharded`) and the blocks are gathered; otherwise the
        single-device solve runs.  `last_path` says which ran.
        """
        check_mesh(mesh)
        c = self.config
        args = (poses, self.count, self.odo_Z, self.loop_i, self.loop_j, self.loop_Z,
                self.loop_valid)
        kw = dict(iters=c.iters, cg_iters=c.cg_iters, damping=c.damping)
        if mesh is not None and mesh.size > 1 and poses.shape[0] % mesh.size == 0:
            from ros_stereo_slam_tpu_torch.parallel import dist_pgo

            self.last_path = "chain_sharded"
            return all_gather(dist_pgo.optimize_chain_sharded(mesh, *args, **kw), mesh)
        self.last_path = "single"
        return optimize(*args, **kw)

    # -- g2o text I/O (the reference's saveStructure, poseGraph.h:140-179) --

    def save(self, path: str, poses: np.ndarray) -> None:
        """g2o dump: VERTEX_SE3:QUAT for vertices 0..count-1 of `poses`, then
        EDGE_SE3:QUAT for the odometry chain and the valid loop edges."""
        Zs = self.odo_Z[1:self.count].cpu().numpy()
        n = min(self.n_loops, self.loop_i.shape[0])
        lv = self.loop_valid[:n].cpu().numpy()
        li, lj = self.loop_i[:n].cpu().numpy()[lv], self.loop_j[:n].cpu().numpy()[lv]
        lz = self.loop_Z[:n].cpu().numpy()[lv]
        with open(path, "w") as f:
            for i, row in enumerate(_g2o_fields(poses[:self.count])):
                f.write(f"VERTEX_SE3:QUAT {i} {row}\n")
            for i, row in enumerate(_g2o_fields(Zs), start=1):
                f.write(f"EDGE_SE3:QUAT {i - 1} {i} {row} {_G2O_INFO}\n")
            for a, b, row in zip(li, lj, _g2o_fields(lz)):
                f.write(f"EDGE_SE3:QUAT {a} {b} {row} {_G2O_INFO}\n")

    @classmethod
    def load(cls, path: str, config: PGOConfig,
             device: torch.device | str = "cuda") -> tuple["PoseGraph", np.ndarray]:
        """Parse a g2o file written by :meth:`save`.  Returns (graph, poses):
        poses is (max_poses, 4, 4), vertices 0..count-1 filled and identity
        beyond; an edge between consecutive vertices is odometry, any other
        a loop edge."""
        vid, vvals, edges, evals = [], [], [], []
        with open(path) as f:
            for line in f:
                tok = line.split()
                if tok and tok[0] == "VERTEX_SE3:QUAT":
                    vid.append(int(tok[1]))
                    vvals.append([float(x) for x in tok[2:9]])
                elif tok and tok[0] == "EDGE_SE3:QUAT":
                    edges.append((int(tok[1]), int(tok[2])))
                    evals.append([float(x) for x in tok[3:10]])
        g = cls(config, device)
        g.initialize()
        poses = np.tile(np.eye(4, dtype=np.float32), (config.max_poses, 1, 1))
        poses[vid] = _transforms_of(vvals)
        odo = np.tile(np.eye(4, dtype=np.float32), (config.max_poses, 1, 1))
        for (i, j), Z in zip(edges, _transforms_of(evals)):
            if j == i + 1:
                odo[j] = Z
            else:
                g.add_loop(i, j, Z)
        g.odo_Z = torch.from_numpy(odo).to(device)
        g.count = max(vid) + 1 if vid else 1
        return g, poses
