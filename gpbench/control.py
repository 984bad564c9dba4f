"""The control of ``correct``, read on the chip at a cell's own size:

    python3 gpbench/control.py --workload <name> --seeds 11,12,13 --seconds 5

For each seed it runs the cell as the benchmark does (set-up, a short
window) and then reads, on the same sample of the window's answers,

* ``program``: the program's answers against the exact reference (the
  lower reading of each compared number);
* ``control``: the reference computed in TF32 (``reference/precision.py``)
  in the program's place, against the exact reference (the upper reading);

and judges each by the harness's own gate against the cell's limits
(``program_correct``, ``control_correct``: the control must come out not
correct).

``--config-args`` merges a JSON object into the configuration's
``gp.args``: the program's own lower-precision path (for gp2Scale,
``{"gp2Scale_solver_dtype": "bfloat16"}``) is read as one more control.
One JSON line per seed.  The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpbench.harness import check  # noqa: E402
from gpbench.harness.bench import judge, measure  # noqa: E402
from gpbench.harness.spec import Spec  # noqa: E402


def read(spec, workload, seed, seconds, device, config_args=None):
    t0 = time.perf_counter()
    config = None
    if config_args:
        config = spec.config(spec.workload(workload)["config"])
        config["gp"]["args"] = {**config["gp"].get("args", {}),
                                **config_args}
    run = measure(spec, workload, seed, seconds, False, device, t0, config)
    idx, _, refs, program = judge(spec, run, seed, device)
    ctl_ref = spec.reference(run.config["family"], run.op_name).make(
        run.config, run.data, device, "tf32")
    reqs = [run.results[i]["req"] for i in idx]
    answers = [run.results[i]["out"] for i in idx]
    ctl = check.numbers(run.op, ctl_ref.answers(reqs, answers), refs,
                        run.config, run.data)
    limits = run.cell["limits"]
    return {"workload": workload, "seed": seed, "program": program,
            "control": ctl,
            "program_correct": check.verdict(program, limits, idx)[0],
            "control_correct": check.verdict(ctl, limits, idx)[0],
            "sample": len(idx), "done": run.window["done"],
            "setup_s": run.setup_s, "seconds": run.window["seconds"],
            "config_args": config_args or {}, "limits": limits}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--config-args", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    spec = Spec()
    extra = json.loads(a.config_args) if a.config_args else None
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(read(spec, a.workload, seed, a.seconds, a.device,
                              extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
