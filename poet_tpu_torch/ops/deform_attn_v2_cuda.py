"""The separable (v2) deformable-attention forward: its entry and its Hopper
kernel's wrapper and plan.

Counterpart of `poet_tpu/ops/deform_attn_pallas_v2.py:ms_deform_attn_pallas_v2`,
forward only, as JAX's is (it has no VJP). No model path reaches it, in JAX
or here: `ModelConfig` has no v2 value, so it is an op entry of its own.

  * CPU tensors run the plain version, `ops/deform_attn.py:ms_deform_attn_torch`:
    v2 computes the same function (grid_sample bilinear, zero padding,
    `align_corners=False`, f32 sums, the result in the value's dtype).
  * CUDA tensors launch `csrc/ms_deform_attn_v2.cu` on the plan `plan_v2`
    gives: TMA stages the zero-bordered value slab of a (b, h) into each of
    its CTAs (as many as one wave of the card holds), in row bands, by
    multicast over a cluster where a (b, h) takes two CTAs, and each CTA
    samples it from shared memory. Where TMA cannot describe the value
    (a head of D x itemsize not a multiple of 16 bytes, a base off 16 bytes,
    a level wider than a TMA box), each CTA's threads stage its slab
    instead, in clusters of one. A plan that does not fit or a cluster that
    cannot be scheduled raises.
  * Inputs that require grad raise on either device.

Importing this module builds nothing and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from poet_tpu_torch.ops.cuda_build import DTYPE_CODE, V2_LIB, device_guard, level_hw, stream_of
from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch
from poet_tpu_torch.ops.deform_attn_cuda import _check_inputs

MAX_BANDS = 64                 # POET_V2_MAX_BANDS in the source
SMEM_OPTIN_MAX = 232448        # bytes of shared memory one block may use on the H100
ALIGN = 128                    # a TMA box's shared-memory destination; the row pitch
# the dynamic shared memory beyond the buffers: alignment slack for its
# base, then the two mbarriers padded to ALIGN
OVERHEAD = 2 * ALIGN
TMA_BOX_MAX = 256              # elements in any dimension of a TMA box
MAX_CLUSTER = 8                # the portable cluster size; also the most CTAs a (b, h)
# multicast only where one band's (b, h) takes this many CTAs or fewer: on the
# H100, at the CTA counts the plan picks, a cluster of 2 ran 0.5-1.7% under
# the same CTAs each staging alone, clusters of 4 and 8 32-84% over them, and
# several bands 2.5-15% over (tools/bench_v2.py --split)
MULTICAST_MAX = 2
MAX_THREADS = 1024
KEEP_POINTS = 16               # points a thread keeps in registers
KEEP_THREADS = 512             # the kernel's launch bound when it keeps them
H100_SMS = 132
# the source's negative return codes a caller can meet on valid arguments
ERRORS = {-6: "the plan's shared memory exceeds the device's opt-in limit",
          -20: "its cluster cannot be scheduled (cudaOccupancyMaxActiveClusters = 0)",
          -21: "libcuda has no cuTensorMapEncodeTiled",
          -22: "libcuda refused a level's tensor map"}


def slice_bytes_ok(D: int, itemsize: int) -> bool:
    """TMA's rule on the box's inner extent (and the head stride): a
    multiple of 16 bytes."""
    return (D * itemsize) % 16 == 0


def tma_ok(D: int, itemsize: int, spatial_shapes: Sequence[Tuple[int, int]],
           aligned: bool = True) -> bool:
    """Whether TMA can stage the slab: 16-byte rows, a 16-byte aligned base
    (`aligned`), every box dimension within TMA_BOX_MAX."""
    return (slice_bytes_ok(D, itemsize) and aligned and D <= TMA_BOX_MAX
            and all(w + 2 <= TMA_BOX_MAX for _, w in spatial_shapes))


def cell_bytes(D: int, itemsize: int) -> int:
    """A staged cell: D values rounded up to 16 bytes (a thread reads one
    16-byte slice of it)."""
    return -(-D * itemsize // 16) * 16


def row_geometry(spatial_shapes: Sequence[Tuple[int, int]], D: int, itemsize: int):
    """Per padded row, levels in order: (level, padded row in its level,
    box bytes, pitched bytes). A level has H_l + 2 rows of W_l + 2 cells;
    each row is one TMA box (or one row the threads copy), laid at a pitch
    rounded up to ALIGN."""
    rows = []
    for l, (h, w) in enumerate(spatial_shapes):
        box = (w + 2) * cell_bytes(D, itemsize)
        pitch = -(-box // ALIGN) * ALIGN
        rows += [(l, pr, box, pitch) for pr in range(h + 2)]
    return rows


def _greedy(row_bytes: List[int], cap: int) -> List[int]:
    """First padded row of each band when bands are filled in order up to
    `cap` bytes, then the total row count."""
    starts, used = [0], 0
    for r, b in enumerate(row_bytes):
        if used + b > cap:
            starts.append(r)
            used = 0
        used += b
    return starts + [len(row_bytes)]


def plan_bands(spatial_shapes: Sequence[Tuple[int, int]], D: int, itemsize: int,
               budget: int) -> List[int]:
    """Cut the pitched padded rows of a pyramid into row bands.

    Returns the first padded row of each band and then the total row count
    (n_bands + 1 ints, in order). A band holds whole padded rows, at most
    `budget` bytes of them at their pitch. The fewest bands the budget
    allows, and among those the smallest largest band: the kernel's shared
    memory is the largest band (per buffer). Raises when one padded row
    exceeds the budget or more than MAX_BANDS bands are needed.
    """
    row_bytes = [pitch for _, _, _, pitch in row_geometry(spatial_shapes, D, itemsize)]
    if max(row_bytes) > budget:
        raise ValueError(f"a padded row of {max(row_bytes)} bytes exceeds the band budget "
                         f"of {budget} bytes")
    n = len(_greedy(row_bytes, budget)) - 1
    if n > MAX_BANDS:
        raise ValueError(f"{n} bands needed at a budget of {budget} bytes; the kernel takes "
                         f"at most {MAX_BANDS}")
    lo, hi = max(max(row_bytes), -(-sum(row_bytes) // n)), budget
    while lo < hi:                       # the least cap that still needs n bands
        mid = (lo + hi) // 2
        if len(_greedy(row_bytes, mid)) - 1 <= n:
            hi = mid
        else:
            lo = mid + 1
    return _greedy(row_bytes, lo)


@dataclass(frozen=True)
class V2Plan:
    """What one launch of the v2 kernel does (mirrored by the source's
    checks). The grid is (cluster * clusters, H, B), clusters of `cluster`
    CTAs along x; CTA i of a (b, h) takes queries [i * q_per_cta,
    (i + 1) * q_per_cta) in passes of threads / slices, a thread one
    (query, 16-byte slice) of a pass."""

    bands: Tuple[int, ...]        # first padded row of each band, then the row count
    band_bytes: Tuple[int, ...]   # their byte offsets in the pitched slab, then its size
    buffers: int                  # 1, or 2: band k + 1 lands while band k is walked
    buffer_bytes: int             # the largest band
    cluster: int                  # CTAs of a cluster (multicast to all of them)
    clusters: int                 # clusters per (b, h): each stages the slab once
    q_per_cta: int
    threads: int
    slices: int                   # threads per query
    keep: bool                    # several bands: a query's points kept in registers
    box_bytes: int                # the boxes of one slab (its rows unpitched)
    tma: bool                     # staged by TMA; else by each CTA's threads, cluster 1

    @property
    def smem(self) -> int:
        return OVERHEAD + self.buffers * self.buffer_bytes

    @property
    def n_bands(self) -> int:
        return len(self.bands) - 1

    @property
    def passes(self) -> int:
        return -(-self.q_per_cta // (self.threads // self.slices))

    def staged_bytes_per_bh(self) -> int:
        """Bytes a (b, h) brings through the L2: every box (every row the
        threads copy) once per cluster."""
        return self.clusters * self.box_bytes


def plan_v2(B: int, H: int, Q: int, D: int, L: int, P: int,
            spatial_shapes: Sequence[Tuple[int, int]], itemsize: int, sms: int = H100_SMS,
            budget: int = None, aligned: bool = True) -> V2Plan:
    """The v2 kernel's plan for one call.

    Bands: the whole pitched slab in one buffer where it fits the opt-in
    shared memory; else bands within half of it, two buffers. A `budget`
    caps a band (two buffers where two fit). CTAs: at most MAX_THREADS
    (KEEP_THREADS where a query's L P <= 16 points are kept in registers
    across bands), never a CTA of fewer than a warp's worth of slices; one
    band: as many CTAs per (b, h), up to MAX_CLUSTER, as one wave of `sms`
    SMs holds, each taking its queries in passes, in one multicast cluster
    where they are at most MULTICAST_MAX, else each staging the slab alone;
    several bands: a single pass per CTA, as many CTAs per (b, h) as that
    needs, each staging every band alone. Where TMA cannot stage the value
    (`tma_ok`; `aligned`: its base is on 16 bytes), the same CTAs each
    stage their own slab with their threads: clusters of one.
    Raises on a plan the kernel cannot take.
    """
    tma = tma_ok(D, itemsize, spatial_shapes, aligned)
    geometry = row_geometry(spatial_shapes, D, itemsize)
    whole = sum(pitch for _, _, _, pitch in geometry)
    if budget is None:
        if whole + OVERHEAD <= SMEM_OPTIN_MAX:
            bands, buffers = [0, len(geometry)], 1
        else:
            bands, buffers = plan_bands(spatial_shapes, D, itemsize,
                                        (SMEM_OPTIN_MAX - OVERHEAD) // 2), 2
    else:
        bands = plan_bands(spatial_shapes, D, itemsize, budget)
    offsets = [0]
    for _, _, _, pitch in geometry:
        offsets.append(offsets[-1] + pitch)
    band_bytes = [offsets[r] for r in bands]
    largest = max(b - a for a, b in zip(band_bytes[:-1], band_bytes[1:]))
    if budget is not None:
        buffers = 2 if OVERHEAD + 2 * largest <= SMEM_OPTIN_MAX else 1
    if OVERHEAD + buffers * largest > SMEM_OPTIN_MAX:
        raise ValueError(f"a band of {largest} bytes exceeds the {SMEM_OPTIN_MAX} bytes of "
                         f"shared memory a block may use")
    slices = cell_bytes(D, itemsize) // 16
    if slices > MAX_THREADS:
        raise ValueError(f"D={D}: {slices} 16-byte slices a query exceed a CTA's "
                         f"{MAX_THREADS} threads")
    keep = False
    if len(bands) == 2:
        # one band: as many CTAs as one wave holds (what an SM receives is
        # the slab, whatever the cluster), each taking its queries in passes
        # of up to MAX_THREADS
        ctas = max(1, min(MAX_CLUSTER, sms // max(1, B * H), -(-Q * slices // 32)))
        cluster, clusters = (ctas, 1) if ctas <= MULTICAST_MAX else (1, ctas)
        q_per_cta = -(-Q // ctas)
        passes = -(-q_per_cta * slices // MAX_THREADS)
        threads = -(-(-(-q_per_cta // passes)) * slices // 32) * 32
    else:
        # several bands: one pass a CTA, so as many CTAs as the queries need,
        # each staging every band alone (a cluster's barrier before each
        # restage cost more than multicast saved); a query's points kept in
        # registers across the bands where they fit and the smaller CTAs that
        # needs do not stage more often
        def clusters_of(cap):
            per_cta = cap // slices
            n = max(-(-Q // per_cta), -(-sms // max(1, B * H)))
            n = max(1, min(MAX_CLUSTER, n, -(-Q * slices // 32)))
            return n, -(-Q // (n * per_cta))

        n, m = clusters_of(MAX_THREADS)
        keep = L * P <= KEEP_POINTS and clusters_of(KEEP_THREADS) == (n, m)
        cluster, clusters = 1, n * m
        q_per_cta = -(-Q // clusters)
        threads = -(-q_per_cta * slices // 32) * 32
    if not tma:                        # the same CTAs, each staging its own slab
        cluster, clusters = 1, cluster * clusters
    return V2Plan(bands=tuple(bands), band_bytes=tuple(band_bytes), buffers=buffers,
                  buffer_bytes=largest, cluster=cluster, clusters=clusters,
                  q_per_cta=q_per_cta, threads=threads, slices=slices, keep=keep,
                  box_bytes=sum(box for _, _, box, _ in geometry), tma=tma)


# a wrapper call plans once per shape (planning walks every padded row in Python)
_cached_plan = functools.lru_cache(maxsize=64)(plan_v2)


def band_boxes(plan: V2Plan, spatial_shapes: Sequence[Tuple[int, int]], D: int,
               itemsize: int, k: int):
    """The TMA boxes of band k, as the source issues them: per padded row r
    of the band, (issuing CTA rank, level, box origin row y = padded row - 1,
    byte offset in the buffer, bytes). CTA rank c issues every cluster-th
    row from the band's c-th."""
    geometry = row_geometry(spatial_shapes, D, itemsize)
    offsets = [0]
    for _, _, _, pitch in geometry:
        offsets.append(offsets[-1] + pitch)
    first, last = plan.bands[k], plan.bands[k + 1]
    return [((r - first) % plan.cluster, geometry[r][0], geometry[r][1] - 1,
             offsets[r] - plan.band_bytes[k], geometry[r][2]) for r in range(first, last)]


class MSDeformAttnV2:
    """Launches the v2 cluster kernel (`csrc/ms_deform_attn_v2.cu`).

    `launches` counts kernel launches made through `__call__`, and nothing
    else (a call captured into a CUDA graph launches nothing). `smem_budget`
    caps a band's bytes; by default the whole slab is one band where it fits.
    """

    def __init__(self):
        self.launches = 0
        self._sms = {}

    def plan(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             sampling_locations: torch.Tensor, smem_budget: int = None) -> V2Plan:
        """The plan a call on these inputs takes."""
        B, S, H, D = value.shape
        _, Q, _, L, P, _ = sampling_locations.shape
        index = value.get_device()
        if index not in self._sms:
            self._sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
        return _cached_plan(B, H, Q, D, L, P, tuple(spatial_shapes), value.element_size(),
                            self._sms[index], smem_budget, value.data_ptr() % 16 == 0)

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 smem_budget: int = None) -> torch.Tensor:
        """Same contract as `ms_deform_attn_torch`; CUDA tensors only."""
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights)
        plan = self.plan(value, spatial_shapes, sampling_locations, smem_budget)
        lib = V2_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_v2_fwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes),
                (ctypes.c_int * len(plan.bands))(*plan.bands), plan.n_bands, plan.buffers,
                plan.cluster, plan.clusters, plan.q_per_cta, plan.threads, int(plan.keep),
                int(plan.tma), stream_of(value))
        if rc in ERRORS:
            raise RuntimeError(f"ms_deform_attn_v2_fwd: {ERRORS[rc]}; plan {plan}")
        V2_LIB.check(rc, "ms_deform_attn_v2_fwd")
        if not torch.cuda.is_current_stream_capturing():
            self.launches += 1
        return out


MS_DEFORM_ATTN_V2 = MSDeformAttnV2()


def ms_deform_attn_v2(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """The v2 forward (no gradient): CPU -> the plain version, CUDA -> the
    cluster kernel (which raises on what it does not take). Raises if any
    input requires grad."""
    if any(t.requires_grad for t in (value, sampling_locations, attention_weights)):
        raise ValueError("ms_deform_attn_v2 is forward only (JAX's v2 has no VJP): "
                         "its inputs must not require grad")
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return MS_DEFORM_ATTN_V2(value, spatial_shapes, sampling_locations, attention_weights)
