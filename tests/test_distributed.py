"""Multi-process distributed solve: 2 CPU processes over jax.distributed
(Gloo collectives), the mechanics of the multi-host path
(SURVEY section 2 row 20)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest


def test_two_process_solve(data_dir):
    root = str(data_dir.parent.parent)
    worker = os.path.join(root, "tests", "multiprocess_worker.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["XLA_FLAGS"] = ""  # workers use one real CPU device each
    port = "19877"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank), "2", port],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=root,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    objs = []
    for out in outs:
        m = re.search(r"RESULT rank=\d+ status=(\d+) objective=([-\d.]+)", out)
        assert m, out[-2000:]
        assert m.group(1) == "1"
        objs.append(float(m.group(2)))
    np.testing.assert_allclose(objs[0], objs[1], rtol=1e-12)
