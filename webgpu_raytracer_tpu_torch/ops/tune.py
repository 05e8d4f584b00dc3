"""The tuning constants that the port's multi-tile paths read.

The port's own copy of the fields of the JAX package's
`ops/tune.TuneConfig` that its multi-tile sweeps use, at the JAX defaults
(measured there on a TPU; the port has not re-tuned them):

- `DIR_BITS`, `CELL_BITS`, `CELL_FLOOR_BITS`: the coherence sort's key
  (`ops/coherence.py`), over the live ray origins' box (`key_mode="obox"`);
- `M_TILE3`: lanes per ray group of the job-stream path (`narrow="jobs"`,
  the default), the granularity of its cull's worklists and its kernel's
  block size;
- `JOB_CHUNK`: worklist entries per chunk of the job-stream kernel: a
  longer worklist is walked in chunks by several blocks at once and merged
  by the tie rule (`csrc/job_sweep.cu`). The port's own constant (the TPU
  kernel walks one grid step a group), set on the card (`PERF.md` §6);
- `M_TILE2`: lanes per ray tile of the scan path (`narrow="scan"`), one
  near-to-far worklist and one CUDA block each;
- `SUBTILE`: lanes per cone of the cone cull (`ops/cluster_cull.
  cone_worklists_plain`), which the scan path takes with `cull="cone"`.

The narrow phase itself is chosen per call (`narrow="jobs"` | `"scan"`,
threaded from `Renderer` down to `ops/cuda_dense.py`), not here.

Not carried over: the scan kernel's `prefetch_depth`, `proc_batch` and
`scan_batch` (a DMA queue, a stacked MXU matmul and Mosaic's loop overhead:
the TPU's mechanism, over which the JAX package's own tests show its
outputs bit-identical); the measured-negative `seed_k` (with the scan
kernel's seeded start) and `cull_sub`; the measurement-only `debug2`; the
other key modes (`key_mode="sbox"`, sign octants at `dir_bits=1`); the band
and tail knobs.
"""

# Direction bins: DIR_BITS bits per normalised direction component.
DIR_BITS = 2
# Origin-cell bits per axis.
CELL_BITS = 5
# Origin-cell width floor, as the scene extent / 2^CELL_FLOOR_BITS: origin
# spreads below cluster scale (a thin lens's disk) collapse to one cell.
CELL_FLOOR_BITS = 11
# Lanes per ray group: one worklist and one CUDA block (a thread per lane).
M_TILE3 = 128
# Worklist entries per chunk of a split job-sweep worklist. On an H100,
# every job sweep of a spheres 720x480 d10 frame took 11.06 / 10.91 /
# 10.92 / 11.23 / 11.46 ms at 8 / 16 / 20 / 48 / 64 entries (15.67 ms
# unsplit; tools/torch_narrow_times.py --chunks, PERF.md §6).
JOB_CHUNK = 16
# Lanes per scan tile: one keyed worklist and one CUDA block.
M_TILE2 = 1024
# Lanes per direction cone of the cone cull.
SUBTILE = 32

assert M_TILE3 % 32 == 0 and M_TILE3 <= 1024
assert JOB_CHUNK >= 1
assert M_TILE2 % 32 == 0 and M_TILE2 <= 1024 and M_TILE2 % SUBTILE == 0
