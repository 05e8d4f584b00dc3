"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages, so the
JAX reference and the port compute on the same numbers.
"""

import numpy as np
import torch

from webgpu_raytracer_tpu.models.native import NativeWorld
from webgpu_raytracer_tpu.render.worldtris import (_np_kernel_tables,
                                                   build_world_tris)
from webgpu_raytracer_tpu_torch import kernels
from webgpu_raytracer_tpu_torch.ops.dense_trace import bounce_rays
from webgpu_raytracer_tpu_torch.render.worldtris import (build_world_tables,
                                                         tables_from_jax)

from tests.test_two_level import _rays
from tests.torch_scenes import png_bytes  # noqa: F401  (the tests' PNG writer)

# The suite runs in several pytest-xdist workers, each of which imports
# this module while collecting. ATen's OpenMP pool (a thread per core in
# every worker) then oversubscribes the host, and its small ops ran up to
# 50x slower. One intra-op thread per worker.
torch.set_num_threads(1)


def jax_and_port_tables(scene_name, res=32, glb_data=None):
    """(world, JAX WorldTris, port WorldTables on the CPU) of one scene."""
    world = NativeWorld(scene_name, glb_data=glb_data)
    world.update_camera(res, res)
    wt = build_world_tris(world)
    tables = tables_from_jax({k: np.asarray(v)
                              for k, v in wt._asdict().items()})
    return world, wt, tables


def camera_rays(world, res):
    """Pixel-center primary rays (ro, rd), each (R, 3) f32."""
    c = np.asarray(world.camera(), np.float32)
    lane = np.arange(res * res)
    u = ((lane % res).astype(np.float32) + 0.5) / res
    v = 1.0 - ((lane // res).astype(np.float32) + 0.5) / res
    rd = np.stack([c[4 + k] + u * c[8 + k] + v * c[12 + k] - c[k]
                   for k in range(3)], 1).astype(np.float32)
    ro = np.broadcast_to(c[:3], rd.shape).astype(np.float32)
    return ro, rd


def random_rays(R, seed=3):
    """Rays from inside the unit box in random directions, with every 5th
    lane inactive and every 3rd given a finite t_max (as
    tests/test_pallas_interpret.py draws them)."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.9, 0.9, size=(R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    active = np.arange(R) % 5 != 0
    tmax = np.where(np.arange(R) % 3 == 0, 1.5, 1e30).astype(np.float32)
    return ro, rd, active, tmax


def rays8_np(ro, rd, tmax):
    """The (8, R) ray stack [d, o, t_max, 0] as a CPU tensor."""
    R = ro.shape[0]
    out = np.zeros((8, R), np.float32)
    out[0:3] = rd.T
    out[3:6] = ro.T
    out[6] = tmax
    return torch.from_numpy(out)


def assert_near_ties(shade_table, ro, rd, idx_a, idx_b, lanes):
    """Winners that differ on `lanes` must be f64 Moller-Trumbore near-ties
    (the check of tests/test_pallas_interpret.py)."""
    if lanes.size == 0:
        return
    st = np.asarray(shade_table, np.float64)
    v0, e1, e2 = st[:, 0:3], st[:, 3:6], st[:, 6:9]
    ron = np.asarray(ro, np.float64)[lanes]
    rdn = np.asarray(rd, np.float64)[lanes]

    def mt_t(tris):
        s = ron - v0[tris]
        h = np.cross(rdn, e2[tris])
        a = np.einsum("ij,ij->i", e1[tris], h)
        q = np.cross(s, e1[tris])
        return np.einsum("ij,ij->i", e2[tris], q) / a

    np.testing.assert_allclose(mt_t(idx_b[lanes]), mt_t(idx_a[lanes]),
                               rtol=2e-3, atol=2e-4,
                               err_msg="non-tie winner flip")


def np_rays(ro, rd, act, tmax):
    """JAX-fixture rays as numpy: (ro (3, R), rd (3, R), t_max (R,) with 0
    on inactive lanes)."""
    ro = np.stack([np.asarray(c, np.float32) for c in ro])
    rd = np.stack([np.asarray(c, np.float32) for c in rd])
    t = np.where(np.asarray(act), np.asarray(tmax, np.float32), 0.0)
    return ro, rd, t.astype(np.float32)


def stack8(ro, rd, t_max):
    """The (8, R) ray stack [d, o, t_max, 0] of (3, R) arrays, on the CPU."""
    return torch.from_numpy(np.concatenate(
        [rd, ro, t_max[None], np.zeros((1, t_max.size), np.float32)]))


def bounce_case(name, res=16):
    """(port tables on the CPU, ro (3, 2R), rd, t_max, R): the fused ray
    stack of bounce 1 at res^2 (R NEE shadow lanes, then R extension
    lanes), advanced through the port's plain path."""
    world = NativeWorld(name)
    world.update_camera(res, res)
    tables = build_world_tables(world, "cpu")
    cam = torch.from_numpy(np.asarray(world.camera(), np.float32))
    rays8 = bounce_rays(tables, cam, res, res, 1, 8).numpy()
    return tables, rays8[3:6], rays8[0:3], rays8[6], res * res


def job_cases(grid_wt, ladder_world, drain_world):
    """The job-stream path's fixtures: name -> (port tables, ro (3, R),
    rd (3, R), t_max (R,), split lane). tests/test_two_level.py's grid
    (random rays), ladder and drain worlds, and the bounce-1 stacks of
    mixed (35 tiles) and spheres (2,009 tiles) at 16^2."""
    def port(wt):
        return tables_from_jax({k: np.asarray(v)
                                for k, v in wt._asdict().items()})

    ro, rd, act, tmax = _rays(2000)
    out = {"grid": (port(grid_wt), *np_rays(ro, rd, act, tmax), 1000)}
    wt, ro, rd, act, tmax = ladder_world
    out["ladder"] = (port(wt), *np_rays(ro, rd, act, tmax), 384)
    wt, ro, rd, act, tmax = drain_world
    out["drain"] = (port(wt), *np_rays(ro, rd, act, tmax), 1280)
    for name in ("mixed", "spheres"):
        out[name] = bounce_case(name)
    return out


def scaled_case(case_rays):
    """A `job_cases` entry with |d| ~ 10 (primary rays are not unit length)
    and t_max cut to a tenth, every 5th lane's to a hundredth."""
    tables, ro, rd, t_max, split = case_rays
    lane = np.arange(t_max.size)
    t = np.where(lane % 5 == 1, t_max * 0.01, t_max * 0.1)
    return tables, ro, rd * 10.0, t.astype(np.float32), split


TIE_NEXT = [0, 4, 8]
TIE_STRIDE = [2, 3, 10, 11]


def tie_case(grid_wt):
    """The grid fixture with exact-t ties inside its first tile: (JAX
    WorldTris, port tables, copies (bool per triangle), ro (3, R), rd,
    t_max). Triangle j + 1 becomes a copy of triangle j for j in TIE_NEXT,
    and triangle j + 32 a copy of triangle j for j in TIE_STRIDE (the large
    triangles at the head of the table, which many lanes hit): in a walk
    that gives triangles 4w to 4w + 3 to thread w of a warp, the first kind
    of pair sits on one thread and the second on two. A lane that
    hits an original hits its copy at the same t, bit for bit. Both
    packages' tables are rebuilt from the edited features, shade rows and
    corners, the tile's sphere included."""
    import jax.numpy as jnp

    host = {k: np.array(v) for k, v in grid_wt._asdict().items()}
    tw = host["shade_table"].shape[0]
    src = np.array(TIE_NEXT + TIE_STRIDE)
    dst = np.array([j + 1 for j in TIE_NEXT] + [j + 32 for j in TIE_STRIDE])
    feats = host["features"].reshape(-1, 5, tw)
    feats[:, :, dst] = feats[:, :, src]
    for name in ("shade_table", "v0", "e1", "e2"):
        host[name][dst] = host[name][src]
    host["featk3"], host["spheres"], host["shadek3"] = _np_kernel_tables(
        host["features"], host["shade_table"], host["v0"], host["e1"],
        host["e2"])
    copies = np.zeros(tw, bool)
    copies[dst] = True
    wt = grid_wt._replace(**{k: jnp.asarray(host[k]) for k in (
        "features", "shade_table", "v0", "e1", "e2", "featk3", "spheres",
        "shadek3")})
    ro, rd, act, tmax = _rays(2000)
    return (wt, tables_from_jax(host), copies, *np_rays(ro, rd, act, tmax))


def jpeg_from_coefficients(width, height, sampling, seed, quant_bits=8,
                           ids=None, app=b"", restart=0, ac_scale=12.0,
                           dc_spread=60, separate_scans=False):
    """A sequential Huffman JPEG of random quantised coefficients with any
    sampling factors: `sampling` is one (h, v) per component. The blocks
    of each component are drawn from a seeded generator (DC around 0,
    AC falling off with frequency), quantisation tables are random (8-bit,
    or 16-bit with SOF1), and the scan is interleaved (one component:
    its blocks one by one) with the standard Huffman tables, restart
    markers every `restart` MCUs. `app` goes before the frame (JFIF,
    Adobe, ...). Pillow's encoder writes only a few samplings; any valid
    stream must decode the same in both."""
    import struct

    from webgpu_raytracer_tpu_torch.utils.images import (_AC_CODES,
                                                         _DC_CODES, _AC_LUMA,
                                                         _DC_LUMA, ZIGZAG)

    rs = np.random.default_rng(seed)
    n = len(sampling)
    ids = list(range(1, n + 1)) if ids is None else ids
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcu_cols = -(-width // (8 * hmax))
    mcu_rows = -(-height // (8 * vmax))
    qmax = 300 if quant_bits == 16 else 24
    quant = rs.integers(1, qmax, (n, 64))
    decay = ac_scale / (1.0 + np.arange(64) / 4.0)
    coef = []
    for c, (h, v) in enumerate(sampling):
        shape = (mcu_rows * v, mcu_cols * h, 64)
        blk = np.round(rs.normal(0, 1, shape) * decay).astype(np.int64)
        blk[..., 0] = rs.integers(-dc_spread, dc_spread + 1, shape[:2])
        blk[..., 1:] = np.clip(blk[..., 1:], -1023, 1023)
        blk[rs.random(shape) < 0.4] = 0  # runs of zeros, EOBs
        coef.append(blk)

    bits = []  # (value, length) words

    def put(val, length):
        if length:
            bits.append((int(val), int(length)))

    def size(v):
        return int(abs(v)).bit_length()

    def amp(v, s):
        return v if v >= 0 else v + (1 << s) - 1

    dc_code, dc_len = _DC_CODES[0]
    ac_code, ac_len = _AC_CODES[0]
    out = bytearray()

    def flush():
        acc, nbits = 0, 0
        for val, length in bits:
            acc = (acc << length) | val
            nbits += length
        pad = -nbits % 8
        acc = (acc << pad) | ((1 << pad) - 1)
        data = acc.to_bytes((nbits + pad) // 8, "big") if nbits else b""
        out.extend(data.replace(b"\xff", b"\xff\x00"))
        bits.clear()

    def seg(marker, body):
        return struct.pack(">HH", marker, len(body) + 2) + body

    def scan_blocks(comps):
        """Blocks in decode order: MCUs of h x v blocks of each component,
        or one component's blocks holding samples one by one."""
        if len(comps) == 1:
            h0, v0 = sampling[comps[0]]
            return [[(comps[0], by, bx)]
                    for by in range(-(-height * v0 // (8 * vmax)))
                    for bx in range(-(-width * h0 // (8 * hmax)))]
        return [[(c, my * sampling[c][1] + dy, mx * sampling[c][0] + dx)
                 for c in comps for dy in range(sampling[c][1])
                 for dx in range(sampling[c][0])]
                for my in range(mcu_rows) for mx in range(mcu_cols)]

    def scan(comps):
        pred = [0] * n
        for m, mcu in enumerate(scan_blocks(comps)):
            if restart and m and m % restart == 0:
                flush()
                out.extend(bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
                pred = [0] * n
            for c, by, bx in mcu:
                zz = coef[c][by, bx][ZIGZAG]
                diff = int(zz[0]) - pred[c]
                pred[c] = int(zz[0])
                s = size(diff)
                put(dc_code[s], dc_len[s])
                put(amp(diff, s), s)
                run = 0
                last = max([k for k in range(1, 64) if zz[k]] or [0])
                for k in range(1, last + 1):
                    v = int(zz[k])
                    if not v:
                        run += 1
                        continue
                    while run > 15:
                        put(ac_code[0xF0], ac_len[0xF0])
                        run -= 16
                    s = size(v)
                    put(ac_code[(run << 4) | s], ac_len[(run << 4) | s])
                    put(amp(v, s), s)
                    run = 0
                if last < 63:
                    put(ac_code[0], ac_len[0])
        flush()
        sos = bytes([len(comps)]) + b"".join(bytes([ids[c], 0])
                                             for c in comps)
        return seg(0xFFDA, sos + bytes([0, 63, 0])) + bytes(out)

    dqt = b"".join(
        bytes([(quant_bits == 16) << 4 | c]) + (
            quant[c][ZIGZAG].astype(">u2").tobytes() if quant_bits == 16
            else quant[c][ZIGZAG].astype(np.uint8).tobytes())
        for c in range(n))
    sof = struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[c], h << 4 | v, c]) for c, (h, v) in enumerate(sampling))
    dht = (bytes([0x00]) + bytes(_DC_LUMA[0]) + bytes(_DC_LUMA[1])
           + bytes([0x10]) + bytes(_AC_LUMA[0]) + bytes(_AC_LUMA[1]))
    head = b"\xff\xd8" + app + seg(0xFFDB, dqt) + seg(
        0xFFC1 if quant_bits == 16 else 0xFFC0, sof) + seg(0xFFC4, dht)
    if restart:
        head += seg(0xFFDD, struct.pack(">H", restart))
    if separate_scans:  # one non-interleaved scan per component
        scans = []
        for c in range(n):
            scans.append(scan([c]))
            out.clear()
        return head + b"".join(scans) + b"\xff\xd9"
    return head + scan(list(range(n))) + b"\xff\xd9"


# -- a CUDA graph's stand-in for CapturedSteps on the CPU ----------------------

class Replay:
    """A CUDA graph's stand-in on the CPU: a replay runs the step on the
    argument tensors it was captured with and writes the results into the
    output tensors of the capture."""

    def __init__(self, step, args, static, out):
        self.step, self.args, self.static, self.out = step, args, static, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        counts = dict(kernels.launches)  # a replay runs no wrapper
        for o, n in zip(self.out, self.step(*self.args, **self.static)):
            if n is not o:
                o.copy_(n)
        kernels.launches.update(counts)


def record_eagerly(self, step, args, static):
    """`CapturedSteps._record` on the CPU: runs nothing. The outputs are
    the arguments the step returns written in place, else new tensors."""
    clones = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    probe = step(*clones, **static)
    out = []
    for o in probe:
        same = [i for i, c in enumerate(clones) if c is o]
        out.append(args[same[0]] if same else torch.empty_like(o))
    return Replay(step, args, static, tuple(out)), tuple(out)
