"""Row-affinity tile partitioning — the scale path's ownership model.

A copy of ``fvgp_tpu/parallel/partition.py`` (numpy only); the one change
is that ``choose_halo`` reads the port's ``parallel/mesh`` names.  The
comments below speak of the JAX package's ``shard_map`` and ICI/DCN; in
the port a mesh rank is one process of a ``torch.distributed`` group, ICI
is the link within a node and DCN the link between nodes.

The block-sparse SpMM is ``segment_sum(tiles[t] @ X[cols[t]], rows[t])``.
With tiles sharded by *list position* alone, every device may contribute to
every output row block, so XLA must all-reduce the full (nb*B, k) product —
``2·(n-1)/n · nb·B·k`` words over ICI per matvec (reduce-scatter +
all-gather), paid tens to hundreds of times per CG/SLQ solve.

Partitioning instead gives device ``d`` exclusive ownership of the
contiguous row-block range ``[d·nb_local, (d+1)·nb_local)`` and places every
tile on its row's owner.  Then each device computes its own output rows
*completely* — no cross-device reduction exists.  The only communication is
making X's column blocks visible (an all-gather of X when it is row-sharded:
``(n-1)/n · nb·B·k`` words — **half** the all-reduce volume), and because
Morton ordering (parallel/ordering.py) makes index-contiguous blocks
spatially compact, a compact-support kernel's tiles reference mostly *local*
column blocks, so the all-gather is the next thing to shrink (halo
exchange); ``schedule_stats`` reports the measured halo fraction.

The reference's analogue is the Dask blockwise task fan-out with host-side
COO assembly (ref gp2Scale_covariance.py:230-307) — ownership there is
whichever worker the scheduler picked, and every matvec runs on the *host*
against the assembled CSR.  Here ownership is static, balanced, and aligned
with the collective structure of the solver.
"""

import numpy as np

__all__ = ["partition_schedule", "schedule_stats", "local_row_blocks",
           "tile_balanced_layout", "apply_block_layout", "permute_blocked",
           "halo_plan", "halo_plan_hier"]


def local_row_blocks(nb, n_dev):
    """Row blocks owned per device: ``ceil(nb / n_dev)``.

    The ``shard_map`` training path pads the *point* blocking so ``nb`` is a
    multiple of ``n_dev`` (empty blocks carry mask 0 / unit noise and
    contribute nothing), which makes the row-sharded vectors evenly
    divisible; with an unaligned ``nb`` (GSPMD posterior path) the last
    device simply owns fewer row blocks.
    """
    return -(-nb // n_dev)


def partition_schedule(rows, cols, nb, n_dev, pad_to=None):
    """Reorder a tile schedule so position-sharding equals row ownership.

    rows/cols: (T,) int32 tile block indices (mirrors included; sentinel
    entries ``rows == nb`` are dropped — padding is re-created per device).
    Returns ``(rows_out, cols_out, perm, per_dev)`` where the output arrays
    have length ``per_dev * n_dev``; positions ``[d*per_dev, (d+1)*per_dev)``
    hold exactly the tiles whose row block lies in device ``d``'s range,
    sentinel-padded (``rows == nb``) at each segment's tail.  ``perm`` maps
    output position -> input tile index (-1 for padding), so tile buffers
    assembled in input order can be permuted identically.

    ``pad_to`` (optional) rounds the per-device count up (e.g. a jit-cache
    bucket) — it must be >= the largest per-device count.
    """
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    nb_local = local_row_blocks(nb, n_dev)
    live = np.nonzero(rows < nb)[0]
    owner = np.minimum(rows[live] // nb_local, n_dev - 1)
    counts = np.bincount(owner, minlength=n_dev)
    per_dev = int(counts.max()) if len(live) else 1
    if pad_to is not None:
        if pad_to < per_dev:
            raise ValueError(f"pad_to={pad_to} < max per-device count {per_dev}")
        per_dev = int(pad_to)
    T_out = per_dev * n_dev
    rows_out = np.full(T_out, nb, np.int32)
    cols_out = np.full(T_out, nb, np.int32)
    perm = np.full(T_out, -1, np.int64)
    # stable order within each device keeps the (row-major) input locality
    order = np.argsort(owner, kind="stable")
    src = live[order]
    owner_sorted = owner[order]
    offsets = np.zeros(n_dev + 1, np.int64)
    offsets[1:] = np.cumsum(counts)
    within = np.arange(len(src)) - offsets[owner_sorted]
    dest = owner_sorted * per_dev + within
    rows_out[dest] = rows[src]
    cols_out[dest] = cols[src]
    perm[dest] = src
    return rows_out, cols_out, perm, per_dev


def _greedy_ranges(h, n_dev, max_load, width_cap):
    """Cut ``h`` (per-row-block tile counts) into <= n_dev contiguous ranges
    each with sum <= max_load and width <= width_cap; returns the boundary
    array (n_dev+1,) or None when infeasible."""
    nb = len(h)
    bounds = [0]
    j = 0
    for _ in range(n_dev):
        load = 0
        w = 0
        while j < nb and w < width_cap and load + h[j] <= max_load:
            load += h[j]
            w += 1
            j += 1
        bounds.append(j)
        if j == nb:
            break
    if j < nb:
        return None
    while len(bounds) < n_dev + 1:
        bounds.append(nb)
    return np.asarray(bounds, dtype=np.int64)


def tile_balanced_layout(rows, nb, n_dev, width=None, width_cap=1.5,
                         improve_below=1.05):
    """Balance per-device TILE counts with contiguous variable-width row
    ranges, expressed as a permuted padded block layout.

    Equal contiguous row-block ranges carry unequal tile counts (the Morton
    tiling concentrates tiles where points cluster), and the per-device
    schedule pads every device to the max count — SpMM time is the most
    loaded device.  Choosing variable-width contiguous ranges with ~equal
    tile sums fixes that, and mapping each range onto an equal-width W-block
    shard (empty pad blocks at each segment tail: mask 0, noise 1 — exactly
    the existing padding semantics) keeps every sharded array an even split,
    so the shard_map SpMM and the solver are UNCHANGED; only the block
    indices are remapped.

    rows: (T,) live tile row-block indices (mirrors included — the per-row
    work measure).  ``width`` pins the per-device width W (a jit-shape
    bucket); otherwise W = the split's max width.  Returns ``(layout, W)``
    where ``layout`` is (n_dev*W,) int64: position ``d*W + i`` holds
    original block ``layout[d*W+i]`` (-1 = empty pad), or ``(None, W0)``
    when the equal-width split is already within ``improve_below`` of
    balanced or no capped split improves on it.
    """
    rows = np.asarray(rows)
    rows = rows[rows < nb]
    W0 = local_row_blocks(nb, n_dev)
    h = np.bincount(rows, minlength=nb).astype(np.int64)
    total = int(h.sum())
    if total == 0 or n_dev <= 1:
        return None, W0
    mean = total / n_dev
    owner0 = np.minimum(np.arange(nb) // W0, n_dev - 1)
    load0 = np.bincount(owner0, weights=h, minlength=n_dev)
    balance0 = float(load0.max() / mean)
    if balance0 <= improve_below:
        return None, W0
    cap = int(width) if width is not None else int(np.ceil(width_cap * W0))
    # smallest feasible max load, by binary search over integer loads
    lo = max(int(np.ceil(mean)), int(h.max()))
    hi = int(load0.max())
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        b = _greedy_ranges(h, n_dev, mid, cap)
        if b is not None:
            best = b
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        return None, W0
    widths = np.diff(best)
    loads = np.add.reduceat(np.append(h, 0), best[:-1])
    loads[widths == 0] = 0
    if float(loads.max() / mean) >= balance0:
        return None, W0
    # W bounds every range by construction: unpinned, it IS widths.max();
    # pinned, _greedy_ranges caps each range at `width`
    W = int(width) if width is not None else int(widths.max())
    layout = np.full(n_dev * W, -1, dtype=np.int64)
    for d in range(n_dev):
        w = int(widths[d])
        layout[d * W:d * W + w] = np.arange(best[d], best[d + 1])
    return layout, W


def apply_block_layout(layout, rows, cols, nb):
    """Remap a tile schedule into a permuted block layout.

    Returns ``(rows_m, cols_m, nb_pad)`` where block index j moved to
    position ``pos[j]`` (``layout[pos[j]] == j``).  Sentinel entries
    (``rows == nb``) map to the new sentinel ``nb_pad``.
    """
    layout = np.asarray(layout)
    nb_pad = len(layout)
    pos = np.full(nb + 1, nb_pad, dtype=np.int64)
    real = layout >= 0
    pos[layout[real]] = np.nonzero(real)[0]
    return (pos[np.asarray(rows)].astype(np.int32),
            pos[np.asarray(cols)].astype(np.int32), nb_pad)


def permute_blocked(layout, arr, pad_value=0.0):
    """Gather a block-major array (leading axis = block index, length nb)
    into the layout's order: ``out[p] = arr[layout[p]]``, with pad positions
    (``layout == -1``) filled with ``pad_value``.  Callers reshape flat
    (nb*B, ...) vectors to (nb, B, ...) first."""
    layout = np.asarray(layout)
    arr = np.asarray(arr)
    out = np.full((len(layout),) + arr.shape[1:], pad_value, dtype=arr.dtype)
    real = layout >= 0
    out[real] = arr[layout[real]]
    return out


def halo_plan(rows_p, cols_p, nb, n_dev, bucket=8):
    """Static all-to-all gather plan replacing the full X all-gather.

    Each device's tiles reference only a subset of non-local column blocks
    (Morton ordering + contiguous row ownership make most references
    local); the plan ships exactly those blocks, padded to a uniform
    per-(src, dst) slot count ``S`` so one ``lax.all_to_all`` moves them.

    Input is a PARTITIONED schedule (``partition_schedule`` output: device
    d's tiles at positions [d·per, (d+1)·per), sentinels == nb).  Returns
    ``(cols_remap, send_sel, send_mask, S, stats)``:

    * ``cols_remap`` (len(cols_p),): per-device LOCAL gather positions into
      ``concat([local X blocks (W), received blocks (n_dev*S)])`` —
      position ``W + e*S + s`` holds the s-th block device e sends here.
    * ``send_sel`` (n_dev, n_dev, S): src-local block indices to send
      (``send_sel[e, d, s]`` = local index on e of the s-th block for d).
    * ``send_mask`` (n_dev, n_dev, S): 1.0 on real slots, 0.0 on padding.
    * ``stats``: words moved per matvec column — ``halo_words`` (padded
      all-to-all) vs ``allgather_words``; use the halo path only when it
      wins (the caller decides, with margin).
    """
    rows_p = np.asarray(rows_p)
    cols_p = np.asarray(cols_p)
    if nb % n_dev:
        raise ValueError("halo_plan needs nb divisible by n_dev")
    W = nb // n_dev
    per = len(rows_p) // n_dev
    need = [[None] * n_dev for _ in range(n_dev)]      # [src][dst] -> blocks
    for d in range(n_dev):
        seg = slice(d * per, (d + 1) * per)
        c = cols_p[seg][rows_p[seg] < nb]
        cu = np.unique(c)
        remote = cu[(cu < d * W) | (cu >= (d + 1) * W)]
        src = np.minimum(remote // W, n_dev - 1)
        for e in range(n_dev):
            need[e][d] = remote[src == e]
    S = max([1] + [len(need[e][d])
                   for e in range(n_dev) for d in range(n_dev)])
    S = -(-S // bucket) * bucket
    send_sel = np.zeros((n_dev, n_dev, S), np.int32)
    send_mask = np.zeros((n_dev, n_dev, S), np.float32)
    luts = np.zeros((n_dev, nb + 1), np.int32)         # dst-local positions
    for d in range(n_dev):
        luts[d, d * W:(d + 1) * W] = np.arange(W)
    for e in range(n_dev):
        for d in range(n_dev):
            blocks = need[e][d]
            send_sel[e, d, :len(blocks)] = blocks - e * W
            send_mask[e, d, :len(blocks)] = 1.0
            luts[d, blocks] = W + e * S + np.arange(len(blocks))
    cols_remap = np.empty_like(cols_p)
    for d in range(n_dev):
        seg = slice(d * per, (d + 1) * per)
        cols_remap[seg] = luts[d, np.minimum(cols_p[seg], nb)]
    stats = {
        "S": S,
        "halo_words": n_dev * (n_dev - 1) * S,
        "allgather_words": n_dev * (n_dev - 1) * W,
        # REAL (unpadded) slot usage per ordered pair — the padded
        # all_to_all ships S to every pair, so the uniform S drives the
        # halo-vs-allgather choice; the real counts say how much a
        # hierarchical (per-slice) exchange could still save
        "real_words": int(send_mask.sum()),
    }
    return cols_remap, send_sel, send_mask, S, stats


def halo_plan_hier(rows_p, cols_p, nb, n_slices, per_slice, bucket=8):
    """HIERARCHICAL two-stage halo exchange plan for a 2-D (slice, tiles)
    mesh — the DCN productionization of ``halo_plan``.

    The flat plan's single ``lax.all_to_all`` pads EVERY ordered device
    pair to the global max slot count S, so the padded cross-slice traffic
    is ``per_slice² · n_slices·(n_slices-1) · S`` blocks per matvec even
    though only boundary-band blocks actually cross slices.  This plan
    splits the exchange by mesh axis:

    * **Stage 1 (ICI, direct)**: an all-to-all over the ``tiles`` axis
      ships same-slice remote blocks, padded to the intra-slice max
      ``S_ici``.
    * **Stage 2a (ICI, forward)**: a second ``tiles``-axis all-to-all
      moves every block that must cross slices onto the device whose
      tiles-coordinate matches its destination's (the *forwarder*),
      padded to ``S_fwd``.
    * **Stage 2b (DCN)**: one all-to-all over the ``slice`` axis ships
      the forwarded blocks between same-coordinate devices, padded to the
      cross-slice max ``S_dcn`` — the only DCN traffic, and it tracks the
      slice boundary surface instead of the global pad:
      ``per_slice · n_slices·(n_slices-1) · S_dcn`` blocks per matvec,
      a ≥ per_slice× reduction even when ``S_dcn == S``.

    Input contract matches ``halo_plan`` (a partitioned schedule; flat
    device index ``d = slice·per_slice + tiles_coord`` owns row blocks
    ``[d·W, (d+1)·W)``).  Returns ``(cols_remap, plan, stats)`` with

    * ``cols_remap``: per-device gather positions into
      ``concat([local W blocks, stage-1 recv (per_slice·S_ici),
      stage-2b recv (n_slices·S_dcn)])``;
    * ``plan = (sel_ici, m_ici, sel_fwd, m_fwd, fwd_sel, m_dcn)`` —
      leading-axis device-sharded runtime arrays for
      ``ops.sparse_lml._halo_hier_spmv_factory``;
    * ``stats``: per-matvec-column word counts split by fabric
      (``ici_words``/``dcn_words``) plus the pad sizes.
    """
    rows_p = np.asarray(rows_p)
    cols_p = np.asarray(cols_p)
    n_dev = n_slices * per_slice
    if nb % n_dev:
        raise ValueError("halo_plan_hier needs nb divisible by n_dev")
    if n_slices < 2 or per_slice < 1:
        raise ValueError("halo_plan_hier needs n_slices >= 2")
    W = nb // n_dev
    per = len(rows_p) // n_dev
    ici_need = {}                 # (src_dev, dst_tiles_coord) -> blocks
    cross = [None] * n_dev        # dst_dev -> remote cross-slice blocks
    for d in range(n_dev):
        s = d // per_slice
        seg = slice(d * per, (d + 1) * per)
        c = cols_p[seg][rows_p[seg] < nb]
        cu = np.unique(c)
        remote = cu[(cu < d * W) | (cu >= (d + 1) * W)]
        src = np.minimum(remote // W, n_dev - 1)
        same = (src // per_slice) == s
        t = d % per_slice
        for e in np.unique(src[same]):
            ici_need[(int(e), t)] = remote[same & (src == e)]
        cross[d] = remote[~same]
    S_ici = max([1] + [len(v) for v in ici_need.values()])
    S_ici = -(-S_ici // bucket) * bucket
    # stage 2a: forwarding lists — blocks each source device ships to each
    # forwarder coordinate, deduplicated across destination slices
    fwd_lists = {}                # (src_dev, fwd_tiles_coord) -> [blocks]
    fwd_pos = {}                  # (src_dev, fwd_tiles_coord, block) -> slot
    for d in range(n_dev):
        t = d % per_slice
        for b in cross[d]:
            e = int(min(b // W, n_dev - 1))
            key = (e, t)
            if (e, t, int(b)) not in fwd_pos:
                lst = fwd_lists.setdefault(key, [])
                fwd_pos[(e, t, int(b))] = len(lst)
                lst.append(int(b))
    S_fwd = max([1] + [len(v) for v in fwd_lists.values()])
    S_fwd = -(-S_fwd // bucket) * bucket
    # stage 2b: per (forwarder, dst slice) slot lists + the dst-side max
    S_dcn = max([1] + [len(cross[d][np.minimum(cross[d] // W, n_dev - 1)
                                    // per_slice == se])
                       for d in range(n_dev)
                       for se in range(n_slices)])
    S_dcn = -(-S_dcn // bucket) * bucket
    sel_ici = np.zeros((n_dev, per_slice, S_ici), np.int32)
    m_ici = np.zeros((n_dev, per_slice, S_ici), np.float32)
    sel_fwd = np.zeros((n_dev, per_slice, S_fwd), np.int32)
    m_fwd = np.zeros((n_dev, per_slice, S_fwd), np.float32)
    fwd_sel = np.zeros((n_dev, n_slices, S_dcn), np.int32)
    m_dcn = np.zeros((n_dev, n_slices, S_dcn), np.float32)
    luts = np.zeros((n_dev, nb + 1), np.int32)
    for d in range(n_dev):
        luts[d, d * W:(d + 1) * W] = np.arange(W)
    for (e, t), blocks in ici_need.items():
        sel_ici[e, t, :len(blocks)] = np.asarray(blocks) - e * W
        m_ici[e, t, :len(blocks)] = 1.0
        # receiver (same slice as e, coord t) sees e's payload at recv
        # index t_e = e % per_slice
        s = e // per_slice
        dst = s * per_slice + t
        luts[dst, blocks] = (W + (e % per_slice) * S_ici
                             + np.arange(len(blocks)))
    for (e, t), blocks in fwd_lists.items():
        sel_fwd[e, t, :len(blocks)] = np.asarray(blocks) - e * W
        m_fwd[e, t, :len(blocks)] = 1.0
    for d in range(n_dev):
        s, t = d // per_slice, d % per_slice
        src = np.minimum(cross[d] // W, n_dev - 1)
        for se in range(n_slices):
            blocks = cross[d][src // per_slice == se]
            if not len(blocks):
                continue
            fwd = se * per_slice + t           # forwarder device
            # forwarder's stage-2a receive buffer is (per_slice, S_fwd)
            # flattened; block b from source e sits at e%per_slice · S_fwd
            # + its slot in fwd_lists[(e, t)]
            pos = np.array([(int(min(b // W, n_dev - 1)) % per_slice)
                            * S_fwd
                            + fwd_pos[(int(min(b // W, n_dev - 1)), t,
                                       int(b))] for b in blocks],
                           np.int32)
            fwd_sel[fwd, s, :len(blocks)] = pos
            m_dcn[fwd, s, :len(blocks)] = 1.0
            luts[d, blocks] = (W + per_slice * S_ici + se * S_dcn
                               + np.arange(len(blocks)))
    cols_remap = np.empty_like(cols_p)
    for d in range(n_dev):
        seg = slice(d * per, (d + 1) * per)
        cols_remap[seg] = luts[d, np.minimum(cols_p[seg], nb)]
    stats = {
        "S_ici": S_ici, "S_fwd": S_fwd, "S_dcn": S_dcn,
        "ici_words": n_slices * per_slice * (per_slice - 1)
                     * (S_ici + S_fwd),
        "dcn_words": per_slice * n_slices * (n_slices - 1) * S_dcn,
        "dcn_real_words": int(m_dcn.sum()),
    }
    return cols_remap, (sel_ici, m_ici, sel_fwd, m_fwd, fwd_sel, m_dcn), \
        stats


def dcn_split(stats, n_dev, per_slice, send_mask=None):
    """Split the halo/allgather word counts into DCN (cross-slice) and ICI
    (intra-slice) shares for a 2-D ``(slice, tiles)`` mesh — the comm-model
    diagnostic logged at n_slices > 1 (docs/source/comm_model.md).  With
    ``send_mask`` also reports the REAL cross-slice words (what a
    hierarchical exchange would ship instead of the padded uniform S)."""
    if per_slice <= 0 or n_dev % per_slice:
        raise ValueError("per_slice must divide n_dev")
    cross_pairs = n_dev * (n_dev - per_slice)
    ici_pairs = n_dev * (per_slice - 1)
    out = {
        "halo_dcn_words": cross_pairs * stats["S"],
        "halo_ici_words": ici_pairs * stats["S"],
        "allgather_dcn_words": cross_pairs * (
            stats["allgather_words"] // max(n_dev * (n_dev - 1), 1)),
        "allgather_ici_words": ici_pairs * (
            stats["allgather_words"] // max(n_dev * (n_dev - 1), 1)),
    }
    if send_mask is not None:
        sm = np.asarray(send_mask)
        slice_of = np.arange(n_dev) // per_slice
        cross = slice_of[:, None] != slice_of[None, :]
        out["halo_dcn_real_words"] = int(sm[cross].sum())
    return out


def schedule_stats(rows, cols, nb, n_dev, block_size, n_rhs=1, elt_bytes=4):
    """Ownership-balance and communication-volume diagnostics.

    Per matvec of ``n_rhs`` columns (words -> bytes via ``elt_bytes``):

    * ``allreduce_bytes``  — position sharding, GSPMD all-reduce of the full
      output: ``2 (n-1)/n · nb·B·k``.
    * ``allgather_bytes``  — row ownership, X row-sharded then all-gathered:
      ``(n-1)/n · nb·B·k``.
    * ``halo_bytes``       — row ownership + halo exchange (each device
      fetches only the distinct non-local column blocks its tiles touch);
      the lower bound the current all-gather leaves on the table.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    live = rows < nb
    rows = rows[live]
    cols = cols[live]
    nb_local = local_row_blocks(nb, n_dev)
    owner = np.minimum(rows // nb_local, n_dev - 1)
    counts = np.bincount(owner, minlength=n_dev).astype(np.int64)
    total = int(counts.sum())
    mean = total / n_dev if n_dev else 0.0
    B = block_size
    word = B * n_rhs * elt_bytes
    halo_blocks = 0
    local_tiles = 0
    for d in range(n_dev):
        sel = owner == d
        c = cols[sel]
        in_range = (c >= d * nb_local) & (c < (d + 1) * nb_local)
        local_tiles += int(np.sum(in_range))
        halo_blocks += len(np.unique(c[~in_range]))
    frac = (n_dev - 1) / n_dev if n_dev > 1 else 0.0
    return {
        "n_dev": n_dev,
        "tiles_per_device": counts.tolist(),
        "balance": float(counts.max() / mean) if total else 1.0,
        "local_tile_fraction": local_tiles / total if total else 1.0,
        "halo_col_blocks": halo_blocks,
        "allreduce_bytes": int(2 * frac * nb * word),
        "allgather_bytes": int(frac * nb * word),
        "halo_bytes": int(halo_blocks * word),
    }


def choose_halo(rows_p, cols_p, nb, mesh, halo_mode="auto", dcn_ratio=8.0,
                bucket=None):
    """Pick the CG-iterate gather collective for a partitioned schedule —
    THE shared cost model of the training step and the committed posterior
    solver (it lived as two near-verbatim copies before; a margin or
    pair-weighting change in one silently diverged the paths).

    Returns None when ``halo_mode`` disables halos, else a dict:

    * ``engaged``: None (all-gather wins), ``"flat"``, or ``"hier"``
    * ``halo_S``: the SpMM-program key — the flat pad size (int) or the
      ``("hier", S_ici, S_fwd, S_dcn)`` tuple
    * ``cols_remap``: the solve-side column list for the engaged plan
    * ``plan``: the plan arrays, in the SpMM's trailing-argument order —
      ``(send_sel, send_mask)`` flat, the six ``halo_plan_hier`` arrays
      hierarchical.  Callers cast the non-int arrays to the solver dtype
      and device_put with their own shardings.
    * ``stats`` / ``hier_stats`` / ``send_mask``: volume accounting for
      the debug logs (``dcn_split``).

    Selection: the flat plan engages when its word volume beats the
    all-gather by the 0.8 margin (or is forced); on a 2-D (slice, tiles)
    mesh the hierarchical two-stage plan is preferred when its
    fabric-weighted volume (ICI words + R·DCN words, R = ``dcn_ratio``)
    beats BOTH, or ``halo_mode == "hier"`` forces it."""
    if halo_mode in (False, "off"):
        return None
    from .mesh import SLICE_AXIS, TILE_AXIS, tile_device_count
    n_dev = tile_device_count(mesh)
    W = nb // n_dev
    if bucket is None:
        bucket = max(8, W // 8)
    cols_remap, send_sel, send_mask, hS, hstats = halo_plan(
        rows_p, cols_p, nb, n_dev, bucket=bucket)
    out = {"engaged": None, "halo_S": None, "cols_remap": None,
           "plan": (), "stats": hstats, "hier_stats": None,
           "send_mask": send_mask}
    if SLICE_AXIS in mesh.shape and int(mesh.shape[SLICE_AXIS]) > 1:
        ns = int(mesh.shape[SLICE_AXIS])
        ps = int(mesh.shape[TILE_AXIS])
        cr2, plan2, hier_stats = halo_plan_hier(rows_p, cols_p, nb, ns, ps,
                                                bucket=bucket)
        out["hier_stats"] = hier_stats
        R = float(dcn_ratio)
        ici_pairs = ns * ps * (ps - 1)
        cross_pairs = ns * ps * ps * (ns - 1)
        pair_w = ici_pairs + R * cross_pairs
        cost_ag = pair_w * W
        cost_flat = pair_w * hS
        cost_hier = hier_stats["ici_words"] + R * hier_stats["dcn_words"]
        if (halo_mode == "hier"
                or (halo_mode in ("auto", True, "on")
                    and cost_hier <= 0.8 * min(cost_ag, cost_flat))):
            out.update(engaged="hier",
                       halo_S=("hier", hier_stats["S_ici"],
                               hier_stats["S_fwd"], hier_stats["S_dcn"]),
                       cols_remap=cr2, plan=tuple(plan2))
            return out
    if (halo_mode in (True, "on", "hier")
            or hstats["halo_words"] <= 0.8 * hstats["allgather_words"]):
        out.update(engaged="flat", halo_S=hS, cols_remap=cols_remap,
                   plan=(send_sel, send_mask))
    return out
