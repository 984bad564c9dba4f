"""Data container + validation (a copy of ``fvgp_tpu/models/gp_data.py``).

Host-side: x_data stays numpy (or a plain list for non-Euclidean input
spaces, where each point is an arbitrary Python object and index_set_dim is
1).  Device copies are owned by the prior, which is the first consumer;
``device`` is the torch device resolved from ``compute_device``.
Append bookkeeping keeps (x_old, x_new) snapshots so the linalg layer can do
blocked rank-n factor updates.
"""

import numpy as np

from ..config import resolve_device
from ..parallel.tile_structure import TileStructure


class GPdata:
    # class-level defaults so pickles from before the content token keep
    # unpickling cleanly
    _content_token = None
    _content_gen = -1

    def __init__(self, x_data, y_data,
                 args=None,
                 noise_variances=None,
                 ram_economy=False,
                 gp2Scale=False,
                 compute_device="cuda",
                 gp2Scale_batch_size=10000):

        if not isinstance(x_data, (np.ndarray, list)):
            raise AssertionError("x_data must be np.ndarray or list")
        if not (isinstance(y_data, np.ndarray) and y_data.ndim in (1, 2)):
            raise AssertionError("y_data must be a 1-d or 2-d np.ndarray")
        if noise_variances is not None:
            if not (isinstance(noise_variances, np.ndarray) and noise_variances.ndim == 1):
                raise AssertionError("noise_variances must be a 1-d np.ndarray or None")
            if len(noise_variances) != len(y_data):
                raise AssertionError("noise_variances and y_data have different lengths")
        if len(x_data) != len(y_data):
            raise AssertionError("x_data and y_data have different lengths.")

        if y_data.ndim == 1:
            y_data = y_data.reshape(-1, 1)

        if isinstance(x_data, np.ndarray):
            if x_data.ndim != 2:
                raise AssertionError("Euclidean x_data must be 2-d (n_points x input_dim)")
            self.Euclidean = True
            self.index_set_dim = x_data.shape[1]
            self.input_set_dim = x_data.shape[1]
        else:
            self.Euclidean = False
            self.index_set_dim = 1
            self.input_set_dim = 1

        self.args = {} if args is None else args
        # gp2Scale: order points along a Morton curve so index-contiguous
        # covariance tiles are spatially compact (parallel/ordering.py).
        # Opt out with args['gp2Scale_reorder']=False.
        if gp2Scale and self.Euclidean and self.args.get("gp2Scale_reorder", True):
            from ..parallel.ordering import morton_order
            from ..utils import structure_cache as sc
            from ..utils.logging import phase_timer
            with phase_timer("fvgp.data.morton"):
                # the permutation is a pure function of the point cloud and
                # costs ~2 s at N=1M: content-addressed disk reuse
                # (utils/structure_cache) makes repeat cold starts I/O
                cdir = sc.cache_dir(self.args)
                perm = None
                if cdir:
                    ckey = sc.content_key("morton", np.asarray(x_data))
                    hit = sc.load(cdir, "morton", ckey)
                    if hit is not None:
                        perm = hit["perm"]
                if perm is None:
                    perm = morton_order(x_data)
                    if cdir:
                        sc.store(cdir, "morton", ckey, perm=perm)
                x_data = x_data[perm]
                y_data = y_data[perm]
                if noise_variances is not None:
                    noise_variances = noise_variances[perm]
        self.x_data = x_data
        self.y_data = y_data
        self.noise_variances = noise_variances
        self.x_old = self.y_old = self.noise_variances_old = None
        self.x_new = self.y_new = self.noise_variances_new = None
        self.point_number = len(x_data)
        # monotone data-identity token: bumped on every update() so caches
        # keyed on dataset content (e.g. the gp2Scale tile-liveness mask)
        # can tell "same N, different points" apart from "unchanged data"
        self.generation = 0
        # the gp2Scale tile structure's host caches, shared by the training
        # pass and the committed posterior solver (parallel/tile_structure)
        self.tile_structure = TileStructure(self)
        self.ram_economy = ram_economy
        self.gp2Scale = gp2Scale
        self.gp2Scale_batch_size = gp2Scale_batch_size
        self.compute_device = compute_device
        self.device = resolve_device(compute_device)
        # multi-task bookkeeping (set by fvGP via set_fvgp_data)
        self.fvgp_x_data = None
        self.fvgp_y_data = None
        self.fvgp_noise_variances = None
        self.x_out = None
        self._check_for_nan()

    # ------------------------------------------------------------------
    @property
    def content_token(self):
        """blake2b hex of the current x_data bytes — the dataset component
        of disk-cache keys (utils/structure_cache).  Lazily computed, tied
        to the in-process ``generation`` token; None for non-Euclidean
        (arbitrary-object) inputs, which have no canonical byte form."""
        if not self.Euclidean:
            return None
        if self._content_token is None or self._content_gen != self.generation:
            from ..utils.structure_cache import content_key
            self._content_token = content_key(np.asarray(self.x_data))
            self._content_gen = self.generation
        return self._content_token

    # ------------------------------------------------------------------
    def set_fvgp_data(self, fvgp_x_data, fvgp_y_data, fvgp_noise_variances, x_out):
        """Record the untransformed multi-task dataset (ref gp_data.py:61)."""
        self.fvgp_x_data = fvgp_x_data
        self.fvgp_y_data = fvgp_y_data
        self.fvgp_noise_variances = fvgp_noise_variances
        if not (isinstance(x_out, np.ndarray) or x_out is None or isinstance(x_out, list)):
            raise AssertionError("wrong format in x_out")
        if isinstance(x_out, np.ndarray) and x_out.ndim != 1:
            raise AssertionError("x_out must be 1-d")
        self.x_out = x_out
        if self.Euclidean:
            self.input_set_dim = self.index_set_dim - 1

    # ------------------------------------------------------------------
    def update(self, x_data_new, y_data_new, noise_variances_new=None, append=True):
        """Append or overwrite the dataset (ref gp_data.py:70)."""
        if not isinstance(x_data_new, (np.ndarray, list)):
            raise AssertionError("x_data_new must be np.ndarray or list")
        if not isinstance(y_data_new, np.ndarray):
            raise AssertionError(f"y_data_new must be np.ndarray, got {type(y_data_new)}")
        if noise_variances_new is not None and not (
                isinstance(noise_variances_new, np.ndarray) and noise_variances_new.ndim == 1):
            raise AssertionError("noise_variances_new must be a 1-d np.ndarray or None")
        if self.Euclidean:
            if not (isinstance(x_data_new, np.ndarray) and x_data_new.ndim == 2):
                raise AssertionError("Euclidean x_data_new must be a 2-d np.ndarray")
        else:
            if not isinstance(x_data_new, list):
                raise AssertionError("non-Euclidean x_data_new must be a list")

        if self.noise_variances is not None and noise_variances_new is None:
            raise Exception(
                "Please provide noise_variances in the data update because you did at "
                "initialization or during a previous update.")
        if self.noise_variances is None and noise_variances_new is not None:
            raise Exception(
                "You did not initialize noise but included noise in the update. "
                "Please reinitialize in this case.")
        if y_data_new.ndim == 1:
            y_data_new = y_data_new.reshape(-1, 1)

        if self.gp2Scale and self.Euclidean and self.args.get("gp2Scale_reorder", True):
            # keep incoming points Morton-ordered (within the chunk for an
            # append; globally for an overwrite)
            from ..parallel.ordering import morton_order
            perm = morton_order(x_data_new)
            x_data_new = x_data_new[perm]
            y_data_new = y_data_new[perm]
            if noise_variances_new is not None:
                noise_variances_new = noise_variances_new[perm]

        if not append:
            self.x_data = x_data_new
            self.y_data = y_data_new
            self.noise_variances = noise_variances_new
            self.x_old = self.y_old = self.noise_variances_old = None
            self.x_new = self.y_new = self.noise_variances_new = None
        else:
            self.x_old = self.x_data
            self.y_old = self.y_data
            self.noise_variances_old = self.noise_variances
            self.x_new = x_data_new
            self.y_new = y_data_new
            self.noise_variances_new = noise_variances_new
            if self.Euclidean:
                self.x_data = np.vstack([self.x_data, x_data_new])
            else:
                self.x_data = self.x_data + x_data_new
            self.y_data = np.vstack([self.y_data, y_data_new])
            if isinstance(noise_variances_new, np.ndarray):
                self.noise_variances = np.append(self.noise_variances, noise_variances_new)
        self.point_number = len(self.x_data)
        self.generation += 1
        self._check_for_nan()

    def _check_for_nan(self):
        if self.Euclidean:
            if np.isnan(np.sum(self.x_data) + np.sum(self.y_data)):
                raise Exception("NaNs encountered in dataset.")

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("tile_structure")         # host caches: rebuilt on demand
        state["device"] = str(self.device)  # loads back onto this device
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.device = resolve_device(state["device"])
        if "generation" not in state:  # pickles from before the token existed
            self.generation = 0
        self.tile_structure = TileStructure(self)
