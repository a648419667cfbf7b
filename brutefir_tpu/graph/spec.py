"""Static graph description for the compiled block step.

Derived from a parsed config (or built directly for tests). Only *structure*
lives here -- everything runtime-controllable (mix gains, coefficient
selection, pre-delays, crossfade activation) is data fed to the jitted step
each block, so control changes never recompile (reference analog: the
`intercomm_area` snapshot at `bfrun.c:1460-1484`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class StageSpec:
    """One topological stage of the filter DAG (filters computable together)."""

    idx: np.ndarray            # [Fs] int32 global filter indices
    casc_local: np.ndarray     # positions within idx that have filter inputs
    casc_slots: np.ndarray     # rows in the eval_prev state for those filters
    any_crossfade: bool        # static: any filter in this stage may crossfade


@dataclass(frozen=True)
class GraphSpec:
    block_length: int          # N (partition length, samples per block)
    n_blocks: int              # B (number of partitions in the ring)
    n_inputs: int              # virtual input channels
    n_outputs: int             # virtual output channels
    n_filters: int
    stages: tuple              # tuple[StageSpec]
    n_casc: int                # filters with filter inputs (eval_prev rows)
    any_crossfade: bool
    real_dtype: np.dtype = np.dtype(np.float32)
    powersave: bool = False  # trace the analog-powersave input gate
    # Static mix sparsity (the reference's unrolled n_bufs=1 mixnscale
    # special case, fftw_convfuns.h:7-501): when every filter has at most
    # one input channel, in_src[f] is that channel (0 for none -- its
    # in_mix entry is structurally zero); when every output channel mixes
    # at most one filter, out_src[c] is that filter (0 for none). The
    # compiled step can then replace the [F, C] / [C, F] mix matmuls
    # with gather+scale (opt-in BRUTEFIR_TPU_SPARSE_MIX, graph/compile.py).
    # None = general structure, dense matmul.
    in_src: tuple = None       # tuple[int, ...] | None, length F
    out_src: tuple = None      # tuple[int, ...] | None, length n_outputs

    @property
    def n_fft(self) -> int:
        return 2 * self.block_length

    @property
    def n_bins(self) -> int:
        """Packed spectral bins (Nyquist folded into bin 0) -- power of two."""
        return self.block_length

    @property
    def complex_dtype(self):
        return np.complex64 if self.real_dtype == np.float32 else np.complex128

    def ring_shape(self) -> tuple:
        """[F, B, 2, K] persistent spectra ring."""
        return (self.n_filters, self.n_blocks, 2, self.n_bins)

    def bank_shape(self, n_entries: int) -> tuple:
        """[E, B, 2, K] coefficient bank."""
        return (n_entries, self.n_blocks, 2, self.n_bins)


def build_graph_spec(
    block_length: int,
    n_blocks: int,
    n_inputs: int,
    n_outputs: int,
    filter_inputs: Sequence[Sequence[int]],
    crossfade_flags: Sequence[bool],
    real_dtype=np.float32,
    powersave: bool = False,
    channel_inputs: Sequence[Sequence[int]] = None,
    output_sources: Sequence[Sequence[int]] = None,
) -> GraphSpec:
    """Topologically stage the filter DAG.

    ``filter_inputs[f]`` lists the filters feeding filter f (from_filters
    edges). Assumes cycle-free (config validation rejects cycles, mirroring
    `bfconf.c:2032-2048`).

    ``channel_inputs[f]`` / ``output_sources[c]`` optionally carry the
    static channel-mix structure (which input channels feed filter f /
    which filters mix into output c); when every row has at most one
    entry the spec records the gather-mix fast path (in_src/out_src).
    """
    F = len(filter_inputs)
    # iterative longest-path depths in Kahn order: the recursive form
    # (one frame + an O(depth) trail tuple per cascade level) hit
    # Python's recursion limit on ~1000-deep from_filters chains
    indeg = [len(filter_inputs[f]) for f in range(F)]
    consumers = [[] for _ in range(F)]
    for f in range(F):
        for u in filter_inputs[f]:
            consumers[u].append(f)
    depth = [0] * F
    ready = [f for f in range(F) if indeg[f] == 0]
    seen = 0
    while ready:
        u = ready.pop()
        seen += 1
        for v in consumers[u]:
            depth[v] = max(depth[v], depth[u] + 1)
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if seen != F:
        raise ValueError("cycle in filter graph")

    n_stages = (max(depth) + 1) if F else 0
    casc_slot = {}
    for f in range(F):
        if filter_inputs[f]:
            casc_slot[f] = len(casc_slot)

    stages: List[StageSpec] = []
    for s in range(n_stages):
        idx = np.array([f for f in range(F) if depth[f] == s], dtype=np.int32)
        casc_local = np.array(
            [i for i, f in enumerate(idx) if filter_inputs[f]], dtype=np.int32)
        casc_slots = np.array(
            [casc_slot[int(f)] for f in idx[casc_local]], dtype=np.int32)
        any_xf = any(crossfade_flags[int(f)] for f in idx)
        stages.append(StageSpec(idx, casc_local, casc_slots, any_xf))

    def single_source(rows, n_rows):
        if rows is None or len(rows) != n_rows:
            return None
        if any(len(r) > 1 for r in rows):
            return None
        return tuple(int(r[0]) if r else 0 for r in rows)

    return GraphSpec(
        block_length=block_length,
        n_blocks=n_blocks,
        n_inputs=n_inputs,
        n_outputs=n_outputs,
        n_filters=F,
        stages=tuple(stages),
        n_casc=len(casc_slot),
        any_crossfade=any(crossfade_flags),
        real_dtype=np.dtype(real_dtype),
        powersave=powersave,
        in_src=single_source(channel_inputs, F),
        out_src=single_source(output_sources, n_outputs),
    )
