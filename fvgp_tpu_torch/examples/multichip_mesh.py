"""Multi-rank gp2Scale over a mesh — the row-partitioned scale path.

Each rank owns a contiguous range of covariance row blocks and exactly the
tiles that write them, so the training step's SpMM (K1 with ``nb_out``)
needs no cross-rank reduction (``parallel/partition.py``).  The same
public-API code runs on one card or on every rank of a ``torchrun``
world, one process per card::

    torchrun --nproc-per-node 4 -m fvgp_tpu_torch.examples.multichip_mesh

With 4 or more ranks (an even count) it also runs the 2-D ``(slice,
tiles)`` mesh.  Without a world it runs on one rank; ``--device cpu`` under
``torchrun`` gives a gloo world of CPU processes."""

import numpy as np

from .. import GP
from ..parallel import mesh as pmesh
from ..parallel.ordering import morton_order
from ._cli import host, run, world_mesh

INIT = np.array([1.0, 2.0, 2.0])
ARGS = {"gp2Scale_block_size": 64, "gp2Scale_precond_width": 2,
        # collective selection: "auto" (default) picks the halo exchange
        # when its measured volume beats the X all-gather; True/False force
        # it
        "gp2Scale_halo_exchange": "auto"}


def data(n=2000):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 60, (n, 2))
    x = x[morton_order(x)]                    # spatial locality -> tiles
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)
    return x, y


def model(device="cuda", args=None, n=2000):
    x, y = data(n)
    return GP(x, y, init_hyperparameters=INIT, gp2Scale=True,
              compute_device=device, args={**ARGS, **(args or {})})


def numbers(gp, n=2000):
    xp = data(n)[0][:5] + 0.05
    return host({"lml": gp.log_likelihood(),
                 "mean": gp.posterior_mean(xp)["m(x)"],
                 "var": gp.posterior_covariance(
                     xp, variance_only=True)["v(x)"]})


def first(device="cuda", args=None, n=2000):
    """The numbers at the first hyperparameters, on the current mesh (or
    none)."""
    return numbers(model(device, args, n), n)


def main(device="cuda", n=2000, max_iter=25):
    with world_mesh(device) as mesh:
        say = print if mesh.rank == 0 else (lambda *a, **k: None)
        say(f"{mesh.size} rank(s), {mesh.backend}, device {mesh.device}")
        gp = model(device, n=n)
        start = numbers(gp, n)
        say("LML:", round(float(start["lml"]), 2))
        # gradient-based training at scale: the row-partitioned mBCG LML
        # is one differentiable program over the ranks
        gp.train(method="adam", max_iter=max_iter)
        end = numbers(gp, n)
        say("trained hps:", np.round(gp.hyperparameters, 3),
            "| LML:", round(float(end["lml"]), 2))
        say("posterior mean:", np.round(end["mean"], 3))
        out = {"first": start, **end, "hyperparameters": gp.hyperparameters,
               "ranks": mesh.size}
        # multi-slice: the same program on a 2-D (slice, tiles) mesh —
        # slices own contiguous Morton ranges, ranks own sub-ranges
        if mesh.size >= 4 and mesh.size % 2 == 0:
            with pmesh.use_mesh(pmesh.make_mesh_2d(2, mesh.size // 2)):
                x, y = data(n)
                gp2 = GP(x, y, init_hyperparameters=INIT, gp2Scale=True,
                         compute_device=device,
                         args={"gp2Scale_block_size": 64})
                out["lml_2d"] = host(gp2.log_likelihood())
                say("2-D (2 x", mesh.size // 2, ") mesh LML:",
                    round(float(out["lml_2d"]), 2))
    return out


if __name__ == "__main__":
    run(main, __doc__)
