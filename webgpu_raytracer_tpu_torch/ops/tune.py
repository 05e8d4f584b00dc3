"""The tuning constants that the port's job-stream path reads.

The port's own copy of the fields of the JAX package's
`ops/tune.TuneConfig` that its default multi-tile sweep uses, at the JAX
defaults (measured there on a TPU; the port has not re-tuned them):

- `DIR_BITS`, `CELL_BITS`, `CELL_FLOOR_BITS`: the coherence sort's key
  (`ops/coherence.py`), over the live ray origins' box (`key_mode="obox"`);
- `M_TILE3`: lanes per ray group, the granularity of the cull's worklists
  and the job kernel's block size.

The other key modes (`key_mode="sbox"`, sign octants at `dir_bits=1`), the
scan kernel's knobs (`m_tile2`, `prefetch_depth`, `proc_batch`,
`scan_batch`), the measured-negative `seed_k` and `cull_sub`, the cone cull
(`exact_cull=False`), `debug2` and the band and tail knobs are not carried
over.
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

assert M_TILE3 % 32 == 0 and M_TILE3 <= 1024
