"""What the examples share: the ``--device`` command line, the one-rank
world that a mesh example creates when no ``torchrun`` world exists, and
host copies of returned numbers."""

import argparse
import contextlib

import numpy as np


def run(main, doc):
    """The ``__main__`` entry of an example: ``--device`` (default: the
    card) into ``main``."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu'")
    main(device=parser.parse_args().device)


@contextlib.contextmanager
def world_mesh(device):
    """``use_mesh(make_mesh())`` over the ``torchrun`` (or spawned) world;
    without one, a one-rank world that this context creates and destroys
    (gloo for the CPU, NCCL for the card)."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh, use_mesh
    owned = not dist.is_initialized()
    mesh = make_mesh(backend="gloo" if device == "cpu" and owned else None)
    try:
        with use_mesh(mesh):
            yield mesh
    finally:
        if owned:
            dist.destroy_process_group()


def host(value):
    """A returned number as float64 numpy (a dict's values in turn)."""
    if isinstance(value, dict):
        return {k: host(v) for k, v in value.items()}
    return np.asarray(value, dtype=np.float64)
