"""The gp2Scale tile structure of one dataset — which covariance tiles are
live at given support lengthscales — and the schedules that the marginal
likelihood and the committed posterior solver run on it.

:class:`TileStructure` (``GPdata.tile_structure``, dropped on pickling)
owns the host caches, the one drift test and the disk cache
(``utils/structure_cache``, kinds ``candidates``, ``liveness`` and
``tile_structure``).  :func:`padded_schedule` is the one-device schedule,
:func:`rank_partition` a mesh rank's share.  The candidates come in the
native runtime's lexicographic ``(i, j)`` order, mirrors appended, and
liveness only filters them: the training pass's structure and the exact
pass's at the same lengthscales are the same sequence."""

import itertools

import numpy as np
import torch

from ..utils import structure_cache as sc
from ..utils import trace
from ..utils.logging import phase_timer

# one stamp per (candidates, dead set) pair in the process: see
# ``TileStructure.training``
_STAMPS = itertools.count(1)


def _candidates(x, ls, radius, B):
    """Symmetric bounding-box candidates at ``ls``: the upper triangle,
    then the mirrors of its off-diagonal pairs."""
    from .sharded_cov import _candidate_pairs
    rows, cols = _candidate_pairs(x, None, ls, radius, B, symmetric=True)
    off = rows < cols
    return (np.concatenate([rows, cols[off]]).astype(np.int32),
            np.concatenate([cols, rows[off]]).astype(np.int32))


def _live(x, ls, rows, cols, B, radius):
    from ..native import tile_live
    return tile_live(x / ls, rows, cols, B, radius)


class TileStructure:
    """The structure caches of one dataset, keyed by its ``(point_number,
    generation)``: the training pass's candidates and dead pairs, and the
    structure at exact lengthscales the committed solver reads."""

    def __init__(self, data):
        self.data = data
        self.clear()

    def clear(self):
        """Drop the candidates, the dead pairs and the exact structure."""
        self._candidates = None     # (key, ls_ref, rows, cols)
        self._dead = None           # (key, ls_ref, sorted dead pair keys)
        self._exact = None          # (key, rows, cols)
        self._stamp = next(_STAMPS)  # new whenever either of the two moves

    def token(self):
        """The dataset's identity in this process."""
        return (self.data.point_number, self.data.generation)

    def support(self, prior, hyperparameters):
        """(lengthscales, radius) of the kernel's support; unit
        lengthscales where the support is unknown (radius infinite)."""
        from .sharded_cov import support_geometry
        ls, radius = support_geometry(prior, hyperparameters, self.data.args)
        if ls is None:
            ls = np.ones(np.shape(self.data.x_data)[1])
        return np.asarray(ls, np.float64), radius

    def _drift(self):
        """The drift band's half-width ``args["gp2Scale_filter_drift"]``."""
        return float(self.data.args.get("gp2Scale_filter_drift", 0.05))

    def within_drift(self, ls, ls_ref):
        """Whether ``ls`` lies inside the drift band around ``ls_ref``."""
        return bool(np.all(np.abs(np.asarray(ls, np.float64) / ls_ref - 1.0)
                           <= self._drift()))

    def _exact_key(self, ls, radius, B, filt):
        return (self.token(), B, float(radius), ls.tobytes(), filt)

    def _disk(self, kind, parts, compute):
        """``compute()``'s arrays (a dict), read from the disk cache under
        ``kind`` and the dataset's content where it holds them, else
        computed and stored there."""
        cdir = sc.cache_dir(self.data.args)
        token = self.data.content_token if cdir else None
        key = sc.content_key(kind, token, *parts) if token is not None \
            else None
        hit = sc.load(cdir, kind, key) if key is not None else None
        if hit is not None:
            return hit
        out = compute()
        if key is not None:
            sc.store(cdir, kind, key, **out)
        return out

    def training(self, ls, radius, B, nb, since=None):
        """(rows, cols, stamp) of the training pass at lengthscales
        ``ls``: the candidates at ``ls·(1+drift)``, reused inside the drift
        band, less the dead pairs of the last liveness pass inside the band
        (pairs keyed by ``nb``, the program's block count).  ``stamp`` names
        the candidates and dead set a filtered structure comes from (None
        unfiltered); where ``since`` is that stamp, neither has moved, so
        the caller's structure stands: ``rows`` and ``cols`` are None and
        the dead-pair filter does not run."""
        args = self.data.args
        x = np.asarray(self.data.x_data, dtype=np.float64)
        tok, radius = self.token(), float(radius)
        c = self._candidates
        if (c is not None and c[0] == (tok, B, radius)
                and self.within_drift(ls, c[1])):
            rows, cols = c[2], c[3]
        else:
            trace.count("structure_passes")
            wide = ls * (1.0 + self._drift())

            def compute():
                with phase_timer("fvgp.sparse_lml.candidates"):
                    rows, cols = _candidates(x, wide, radius, B)
                return {"rows": rows, "cols": cols}
            hit = self._disk("candidates", (B, radius, wide), compute)
            rows, cols = hit["rows"], hit["cols"]
            self._candidates = ((tok, B, radius), ls, rows, cols)
            self._stamp = next(_STAMPS)
        if not (bool(args.get("gp2Scale_tile_filter", True))
                and np.isfinite(radius) and len(rows)):
            return rows, cols, None
        d = self._dead
        if (d is not None and d[0] == (tok, nb, B, radius)
                and self.within_drift(ls, d[1])):
            if since == self._stamp:
                return None, None, since
            keep = ~np.isin(rows.astype(np.int64) * (nb + 1) + cols, d[2])
        else:
            pair_key = rows.astype(np.int64) * (nb + 1) + cols

            def compute():
                with phase_timer("fvgp.sparse_lml.liveness"):
                    return {"keep": np.asarray(
                        _live(x, ls, rows, cols, B, radius), dtype=bool)}
            keep = self._disk("liveness", (B, radius, ls, rows, cols),
                              compute)["keep"].astype(bool)
            self._dead = ((tok, nb, B, radius), ls, np.sort(pair_key[~keep]))
            self._stamp = next(_STAMPS)
            # the structure at exactly these lengthscales: the committed
            # solver's, when it runs at them
            self._exact = (self._exact_key(ls, radius, B, True), rows[keep],
                           cols[keep])
        return rows[keep], cols[keep], self._stamp

    def exact(self, ls, radius, B):
        """(rows, cols) at exactly the lengthscales ``ls``: the candidates
        at ``ls`` and, under ``args["gp2Scale_tile_filter"]``, liveness."""
        x = np.asarray(self.data.x_data, np.float64)
        filt = bool(self.data.args.get("gp2Scale_tile_filter", True))
        key = self._exact_key(ls, radius, B, filt)
        if self._exact is not None and self._exact[0] == key:
            return self._exact[1], self._exact[2]

        def compute():
            with phase_timer("fvgp.committed.structure"):
                rows, cols = _candidates(x, ls, radius, B)
                if filt and np.isfinite(radius) and len(rows):
                    keep = _live(x, ls, rows, cols, B, radius)
                    rows, cols = rows[keep], cols[keep]
            return {"rows": rows, "cols": cols}
        hit = self._disk("tile_structure", (B, float(radius), ls, filt),
                         compute)
        self._exact = (key, hit["rows"], hit["cols"])
        return hit["rows"], hit["cols"]


def row_sorted(rows, cols):
    """(rows, cols) sorted by row, stably: the SpMMs own one output row
    block at a time, and the mirrors come unsorted from the prune."""
    order = np.argsort(rows, kind="stable")
    return rows[order], cols[order]


def padded_schedule(rows, cols, nb):
    """:func:`row_sorted` ``(rows, cols)`` padded with sentinels ``nb`` to
    ``sharded_cov._bucket`` of the tile count."""
    from .sharded_cov import _bucket
    rows, cols = row_sorted(rows, cols)
    T_pad = _bucket(max(len(rows), 1))
    rows_p = np.full(T_pad, nb, np.int32)
    cols_p = np.full(T_pad, nb, np.int32)
    rows_p[:len(rows)] = rows
    cols_p[:len(cols)] = cols
    return rows_p, cols_p


def halo_settings(args):
    """(mode, DCN/ICI cost ratio) of the halo exchange: what
    :func:`rank_partition` reads, and so a cached program's key carries."""
    return (args.get("gp2Scale_halo_exchange", "auto"),
            float(args.get("gp2Scale_dcn_ici_ratio", 8.0)))


def rank_partition(rows, cols, nb, B, mesh, args, dtype, device):
    """This rank's share of ``(rows, cols)`` over ``nb`` row blocks: the
    schedule :func:`row_sorted`, partitioned by row ownership (each
    segment padded to the bucket of the largest), and the gather
    ``partition.choose_halo`` picks.  A dict: the segment's ``rows`` and
    ``cols`` (global blocks), ``rsl`` (the rank's W·B rows), ``halo_S``,
    ``plan`` (tensors, non-integer ones in ``dtype``) and ``cols_remap``
    (None, () and None under the all-gather), ``exchange``, ``schedule``
    (the whole partitioned schedule, ``nb``, the rank count)."""
    from .mesh import tile_device_count
    from .partition import choose_halo, partition_schedule
    from .sharded_cov import _bucket
    n_dev = tile_device_count(mesh)
    W = nb // n_dev
    rows, cols = row_sorted(rows, cols)
    cnt = np.bincount(np.minimum(rows // W, n_dev - 1),
                      minlength=n_dev) if len(rows) else np.ones(1)
    rows_p, cols_p, _, per = partition_schedule(
        rows, cols, nb, n_dev, pad_to=_bucket(int(cnt.max())))
    mode, ratio = halo_settings(args)
    choice = choose_halo(rows_p, cols_p, nb, mesh, halo_mode=mode,
                         dcn_ratio=ratio, bucket=max(8, W // 8))
    r = mesh.rank
    seg = slice(r * per, (r + 1) * per)
    out = {"rows": rows_p[seg], "cols": cols_p[seg],
           "rsl": slice(r * W * B, (r + 1) * W * B), "halo_S": None,
           "plan": (), "cols_remap": None, "exchange": "allgather",
           "schedule": (rows_p, cols_p, nb, n_dev)}
    if choice is not None and choice["engaged"] is not None:
        out.update(
            halo_S=choice["halo_S"], exchange=choice["engaged"],
            plan=tuple(torch.as_tensor(p[r]).to(device) if p.dtype.kind
                       == "i" else torch.as_tensor(p[r], dtype=dtype)
                       .to(device) for p in choice["plan"]),
            cols_remap=torch.as_tensor(choice["cols_remap"][seg]).to(device))
    return out
