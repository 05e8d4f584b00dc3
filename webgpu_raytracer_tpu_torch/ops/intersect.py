"""Ray/scene intersection over the two-level skip-pointer BVH.

The port of the JAX package's `ops/intersect.py`. Every ray carries a
(mode, cursor) state: mode 0 walks the TLAS, mode 1 a BLAS in
instance-local space. Skip pointers are absolutized into the merged node
array (`render/resources.py`), so a jump is a cursor assignment; there is
no stack. Instance-local rays keep the unnormalized direction, so t
compares across spaces.

- `traverse_plain`: the JAX `_traverse` in plain PyTorch, the lanes in lock
  step through one masked loop until none is alive (a host sync a step).
  It works on the lanes still alive, dropping finished ones as the set
  halves, which changes no lane's result: a lane's walk depends on its own
  state alone.
- `csrc/bvh_walk.cu` (`wrt_bvh_walk`): one thread walks one ray to its end
  over the packed records of `pack_walk`; its source says what bounds it on
  the card and what was measured against its design.
- `pack_walk`: the scene as the kernel reads it (`WalkPack`): a node in
  32 bytes, a triangle as (p0, e1, e2) in 48, an instance's matrix rows and
  BLAS span in 64, and whether every node bound is finite. Built once for
  a DeviceScene (`trace.scene_packs`); the walks take it as `pack=`, or
  build it when it is not given.

`intersect_closest` and `intersect_shadow` launch the kernel for CUDA
tensors and take the plain walk (on the unpacked arrays) for CPU tensors;
there is no fallback.
Both evaluate every product, sum and quotient as a separately rounded f32
operation in the order written here (sums of three left to right, the
instance transform row by row plus its translation last), so kernel and
plain walk agree bit for bit, counts of nodes visited and triangles tested
included (`with_stats`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

T_MIN = 1e-3
T_MAX = 1e30


class Hit(NamedTuple):
    t: torch.Tensor         # (R,) f32
    tri_idx: torch.Tensor   # (R,) int32, -1 = miss
    inst_idx: torch.Tensor  # (R,) int32, -1 = miss


class WalkStats(NamedTuple):
    nodes: torch.Tensor  # (R,) int32 nodes visited
    tris: torch.Tensor   # (R,) int32 triangles tested


class WalkPack(NamedTuple):
    """A DeviceScene as `csrc/bvh_walk.cu` reads it: the same bits, one
    16-byte-aligned record a node, a triangle and an instance."""

    nodes: torch.Tensor   # (N, 8) int32: min.xyz bits, skip, max.xyz, data
    tris: torch.Tensor    # (T, 12) f32: p0, 0, p1 - p0, 0, p2 - p0, 0
    insts: torch.Tensor   # (I, 16) int32: inst_inv rows 0-2, start, end, 0, 0
    finite: torch.Tensor  # (1,) int32: 1 when every node bound is finite
    tlas_end: int         # the scene's tlas_count


def pack_walk(scene) -> WalkPack:
    """The walk kernel's records of `scene`, on its device. e1 and e2 are
    the f32 differences `moller_trumbore` forms; an instance's BLAS end is
    `node_skip[inst_blas]`, as the walk reads it on entry. No host sync."""
    i32 = torch.int32
    n = scene.node_min.shape[0]
    nodes = torch.cat([scene.node_min.view(i32), scene.node_skip[:, None],
                       scene.node_max.view(i32), scene.node_data[:, None]],
                      dim=1)
    p = scene.pos[scene.tri_v.long()]
    pad = torch.zeros_like(p[:, 0, :1])
    tris = torch.cat([p[:, 0], pad, p[:, 1] - p[:, 0], pad,
                      p[:, 2] - p[:, 0], pad], dim=1)
    start = scene.inst_blas
    end = scene.node_skip[start.clamp(0, n - 1).long()]
    rows = scene.inst_inv[:, :3, :].reshape(-1, 12).view(i32)
    zero = torch.zeros_like(start)
    insts = torch.cat([rows, torch.stack([start, end, zero, zero], 1)],
                      dim=1)
    finite = (torch.isfinite(scene.node_min).all()
              & torch.isfinite(scene.node_max).all()).to(i32).reshape(1)
    return WalkPack(nodes.contiguous(), tris.contiguous(),
                    insts.contiguous(), finite, int(scene.tlas_count))


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def safe_inv(d):
    """1/d with components below 1e-20 in magnitude replaced by +1e-20
    (the slab test's NaN guard)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)


def aabb_hit(nmin, nmax, ro, inv_d, t_min: float, t_max):
    """Slab test: bool (R,). NaN on either side of a min / max gives NaN,
    which no comparison passes."""
    t1 = (nmin - ro) * inv_d
    t2 = (nmax - ro) * inv_d
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    tn = torch.clamp(tn, min=t_min)
    tf = torch.minimum(tf, t_max)
    return tn <= tf


def moller_trumbore(ro, rd, p0, p1, p2, t_min: float, t_max):
    """(t, hit): t is meaningful only where hit; t_min < t < t_max."""
    e1 = p1 - p0
    e2 = p2 - p0
    h = _cross(rd, e2)
    a = _dot(e1, h)
    ok = torch.abs(a) >= 1e-6
    f = 1.0 / torch.where(ok, a, 1.0)
    s = ro - p0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(rd, q)
    t = f * _dot(e2, q)
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, hit & (t > t_min) & (t < t_max)


def instance_ray(m, ro, rd):
    """A world ray in the space of the (R, 4, 4) matrices m: each row's
    sum left to right, then the translation."""
    lro = torch.stack([_dot(m[:, i, :3], ro) + m[:, i, 3]
                       for i in range(3)], dim=1)
    lrd = torch.stack([_dot(m[:, i, :3], rd) for i in range(3)], dim=1)
    return lro, lrd


def _gather_tri_verts(scene, tri):
    vidx = scene.tri_v[tri.clamp(0, scene.tri_v.shape[0] - 1).long()].long()
    return scene.pos[vidx[:, 0]], scene.pos[vidx[:, 1]], \
        scene.pos[vidx[:, 2]]


class _Lanes:
    """The working set of the plain walk: per-lane state, plus each lane's
    index in the caller's arrays."""

    FIELDS = ("lane", "ro", "rd", "inv_d", "t_max", "in_blas", "tcur",
              "bcur", "bend", "cur_inst", "lro", "lrd", "linv", "best_t",
              "best_tri", "best_inst", "occluded", "nodes", "tris")

    def __init__(self, **kw):
        for k in self.FIELDS:
            setattr(self, k, kw[k])

    def take(self, keep):
        return _Lanes(**{k: getattr(self, k)[keep] for k in self.FIELDS})


def traverse_plain(scene, ro, rd, t_min: float, t_max, active,
                   any_hit: bool):
    """The lock-step walk of the JAX `_traverse`. Returns (Hit, WalkStats)
    for the closest walk, (occluded (R,) bool, WalkStats) for any-hit."""
    R = ro.shape[0]
    dev = ro.device
    i32 = torch.int32
    tlas_end = int(scene.tlas_count)
    n_total = scene.node_min.shape[0]
    n_inst = scene.inst_inv.shape[0]
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (R,))
    inv_d = safe_inv(rd)
    best = t_max.clone()
    out_t, out_tri = best.clone(), torch.full((R,), -1, dtype=i32,
                                              device=dev)
    out_inst = out_tri.clone()
    out_occ = torch.zeros(R, dtype=torch.bool, device=dev)
    out_nodes = torch.zeros(R, dtype=i32, device=dev)
    out_tris = torch.zeros(R, dtype=i32, device=dev)
    zi = torch.zeros(R, dtype=i32, device=dev)
    s = _Lanes(lane=torch.arange(R, device=dev), ro=ro, rd=rd, inv_d=inv_d,
               t_max=t_max, in_blas=torch.zeros(R, dtype=torch.bool,
                                                 device=dev),
               tcur=torch.where(active, 0, tlas_end).to(i32), bcur=zi,
               bend=zi, cur_inst=zi, lro=ro, lrd=rd, linv=inv_d,
               best_t=best, best_tri=out_tri.clone(),
               best_inst=out_inst.clone(), occluded=out_occ.clone(),
               nodes=zi, tris=zi)

    def flush(s):
        out_t[s.lane] = s.best_t
        out_tri[s.lane] = s.best_tri
        out_inst[s.lane] = s.best_inst
        out_occ[s.lane] = s.occluded
        out_nodes[s.lane] = s.nodes
        out_tris[s.lane] = s.tris

    max_iters = 4 * n_total + 64  # the reference's safety bound
    for _ in range(max_iters):
        alive = s.in_blas | (s.tcur < tlas_end)
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        if 2 * n_alive <= s.lane.shape[0]:
            flush(s)
            s = s.take(alive)
            alive = torch.ones(n_alive, dtype=torch.bool, device=dev)
        s.nodes = s.nodes + alive.to(i32)
        tlas_active = ~s.in_blas & (s.tcur < tlas_end)
        cursor = torch.where(s.in_blas, s.bcur, s.tcur)
        c = cursor.clamp(0, n_total - 1).long()
        nmin, nmax = scene.node_min[c], scene.node_max[c]
        skip, data = scene.node_skip[c], scene.node_data[c]
        is_leaf = data != 0
        blas_col = s.in_blas[:, None]
        cur_ro = torch.where(blas_col, s.lro, s.ro)
        cur_inv = torch.where(blas_col, s.linv, s.inv_d)
        limit = s.t_max if any_hit else s.best_t
        hit = aabb_hit(nmin, nmax, cur_ro, cur_inv, t_min, limit)

        # TLAS mode: advance, and enter the instance of a hit leaf.
        enter = tlas_active & hit & is_leaf
        tcur = torch.where(tlas_active,
                           torch.where(hit & ~is_leaf, s.tcur + 1, skip),
                           s.tcur)
        in_blas, bcur, bend = s.in_blas | enter, s.bcur, s.bend
        cur_inst, lro, lrd, linv = s.cur_inst, s.lro, s.lrd, s.linv
        ent = enter.nonzero()[:, 0]
        if ent.numel():
            inst = (data[ent] >> 3).clamp(0, n_inst - 1)
            lro_n, lrd_n = instance_ray(scene.inst_inv[inst.long()],
                                        s.ro[ent], s.rd[ent])
            bstart = scene.inst_blas[inst.long()]
            bcur, bend = bcur.clone(), bend.clone()
            cur_inst, lro, lrd, linv = (cur_inst.clone(), lro.clone(),
                                        lrd.clone(), linv.clone())
            bcur[ent] = bstart
            bend[ent] = scene.node_skip[bstart.clamp(0, n_total - 1).long()]
            cur_inst[ent] = data[ent] >> 3
            lro[ent], lrd[ent], linv[ent] = lro_n, lrd_n, safe_inv(lrd_n)

        # BLAS mode: test a hit leaf's triangles in order, then advance.
        blas_active = s.in_blas
        best_t, best_tri = s.best_t, s.best_tri
        best_inst, occluded, tris = s.best_inst, s.occluded, s.tris
        leaf_lanes = (blas_active & hit & is_leaf).nonzero()[:, 0]
        if leaf_lanes.numel():
            first = data[leaf_lanes] >> 3
            count = data[leaf_lanes] & 7
            o, d = s.lro[leaf_lanes], s.lrd[leaf_lanes]
            bt = best_t[leaf_lanes]
            bi, bn = best_tri[leaf_lanes], best_inst[leaf_lanes]
            occ = occluded[leaf_lanes]
            lim = s.t_max[leaf_lanes]
            for k in range(4):  # at most 4 triangles a leaf
                tri = first + k
                p0, p1, p2 = _gather_tri_verts(scene, tri)
                t, tri_hit = moller_trumbore(o, d, p0, p1, p2, t_min,
                                             lim if any_hit else bt)
                tri_hit = tri_hit & (k < count)
                if any_hit:
                    occ = occ | tri_hit
                else:
                    bt = torch.where(tri_hit, t, bt)
                    bi = torch.where(tri_hit, tri, bi)
                    bn = torch.where(tri_hit, s.cur_inst[leaf_lanes], bn)
            tris = tris.clone()
            tris[leaf_lanes] += count.clamp(max=4)
            if any_hit:
                occluded = occluded.clone()
                occluded[leaf_lanes] = occ
            else:
                best_t, best_tri, best_inst = (best_t.clone(),
                                               best_tri.clone(),
                                               best_inst.clone())
                best_t[leaf_lanes], best_tri[leaf_lanes] = bt, bi
                best_inst[leaf_lanes] = bn

        bcur = torch.where(blas_active,
                           torch.where(hit & ~is_leaf, s.bcur + 1, skip),
                           bcur)
        in_blas = in_blas & ~(blas_active & (bcur >= s.bend))
        if any_hit:  # occluded lanes stop walking
            tcur = torch.where(occluded, tlas_end, tcur).to(i32)
            in_blas = in_blas & ~occluded
        s.in_blas, s.tcur, s.bcur, s.bend = in_blas, tcur, bcur, bend
        s.cur_inst, s.lro, s.lrd, s.linv = cur_inst, lro, lrd, linv
        s.best_t, s.best_tri, s.best_inst = best_t, best_tri, best_inst
        s.occluded, s.tris = occluded, tris
    flush(s)
    stats = WalkStats(out_nodes, out_tris)
    if any_hit:
        return out_occ, stats
    return Hit(out_t, out_tri, out_inst), stats


def _check_pack(pack: WalkPack, dev):
    n, t, i = (pack.nodes.shape[0], pack.tris.shape[0],
               pack.insts.shape[0])
    kernels.check(pack.nodes, "pack.nodes", torch.int32, (n, 8), dev)
    kernels.check(pack.tris, "pack.tris", torch.float32, (t, 12), dev)
    kernels.check(pack.insts, "pack.insts", torch.int32, (i, 16), dev)
    kernels.check(pack.finite, "pack.finite", torch.int32, (1,), dev)
    if min(n, t, i) < 1:
        raise ValueError("the scene needs a node, a triangle, an instance")
    if any(x.data_ptr() % 16 for x in pack[:3]):
        raise ValueError("pack: records must be 16-byte aligned")


def walk_cuda(scene, ro, rd, t_min: float, t_max, active, any_hit: bool,
              with_stats: bool = False, pack: WalkPack | None = None):
    """`csrc/bvh_walk.cu` over CUDA tensors: (Hit or occluded, WalkStats or
    None). The kernel reads `pack` (`pack_walk(scene)` when not given)."""
    if pack is not None and (
            (pack.nodes.shape[0], pack.tris.shape[0], pack.insts.shape[0],
             pack.tlas_end)
            != (scene.node_min.shape[0], scene.tri_v.shape[0],
                scene.inst_inv.shape[0], int(scene.tlas_count))):
        raise ValueError("pack: not built from this scene (node, triangle, "
                         "instance or TLAS counts differ)")
    dev = ro.device
    R = ro.shape[0]
    kernels.check(ro, "ro", torch.float32, (R, 3), dev)
    kernels.check(rd, "rd", torch.float32, (R, 3), dev)
    if pack is None:
        for name in ("node_min", "node_max", "pos", "inst_inv"):
            kernels.check(getattr(scene, name), name, torch.float32,
                          device=dev)
        for name in ("node_skip", "node_data", "tri_v", "inst_blas"):
            kernels.check(getattr(scene, name), name, torch.int32,
                          device=dev)
        pack = pack_walk(scene)
    _check_pack(pack, dev)
    tmax_lane, tmax_all = None, 0.0
    if isinstance(t_max, torch.Tensor) and t_max.dim() > 0:
        tmax_lane = t_max
        kernels.check(tmax_lane, "t_max", torch.float32, (R,), dev)
    else:
        tmax_all = float(t_max)
    if active is not None:
        kernels.check(active, "active", torch.bool, (R,), dev)
    t = tri = inst = occ = None
    if any_hit:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
    else:
        t = torch.empty(R, dtype=torch.float32, device=dev)
        tri = torch.empty(R, dtype=torch.int32, device=dev)
        inst = torch.empty(R, dtype=torch.int32, device=dev)
    stats = None
    if with_stats:
        stats = WalkStats(torch.empty(R, dtype=torch.int32, device=dev),
                          torch.empty(R, dtype=torch.int32, device=dev))
    out = (occ, stats) if any_hit else (Hit(t, tri, inst), stats)
    if R == 0:
        return out
    lib = kernels.library()
    p = kernels.ptr
    with torch.cuda.device(dev):
        code = lib.wrt_bvh_walk(
            p(pack.nodes), pack.nodes.shape[0], pack.tlas_end, p(pack.tris),
            pack.tris.shape[0], p(pack.insts), pack.insts.shape[0],
            p(pack.finite), p(ro), p(rd), p(tmax_lane), tmax_all, t_min,
            p(active), R, int(any_hit), p(t), p(tri), p(inst), p(occ),
            p(stats.nodes if stats else None),
            p(stats.tris if stats else None), kernels.stream(dev))
    kernels.raise_on_error(code, "bvh_walk")
    kernels.launches["bvh_shadow" if any_hit else "bvh_closest"] += 1
    kernels.launches["bvh_walk"] += 1
    return out


def _walk(scene, ro, rd, t_min, t_max, active, any_hit, with_stats, pack):
    if ro.device.type == "cpu":
        out, stats = traverse_plain(scene, ro, rd, t_min, t_max,
                                    _active(ro, active), any_hit)
    else:
        out, stats = walk_cuda(scene, ro, rd, t_min, t_max, active, any_hit,
                               with_stats, pack)
    return (out, stats) if with_stats else out


def _active(ro, active):
    if active is None:
        return torch.ones(ro.shape[0], dtype=torch.bool, device=ro.device)
    return active


def intersect_closest(scene, ro, rd, t_min: float = T_MIN,
                      t_max=T_MAX, active=None, with_stats: bool = False,
                      pack: WalkPack | None = None):
    """Closest hit over the two-level BVH: Hit, and WalkStats with
    with_stats. ro, rd (R, 3) f32; t_max a float or (R,) f32. On the card
    the kernel reads `pack` (built from `scene` when not given); the CPU
    walks `scene`'s arrays."""
    return _walk(scene, ro, rd, float(t_min), t_max, active, False,
                 with_stats, pack)


def intersect_shadow(scene, ro, rd, t_max, t_min: float = T_MIN,
                     active=None, with_stats: bool = False,
                     pack: WalkPack | None = None):
    """Any-hit occlusion: (R,) bool, and WalkStats with with_stats."""
    return _walk(scene, ro, rd, float(t_min), t_max, active, True,
                 with_stats, pack)
