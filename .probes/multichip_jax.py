"""The JAX package's own CPU run of ``examples/multichip.py``, the reference
that ``chip_smoke.py`` phase 14 (d) holds the port's
``python -m plate_inverse_problem_tpu_torch.parallel`` workflow to (no GPU
needed).

Runs the example's source unchanged except that its ``.6e`` number formats
print in full (``repr``), on the 8 virtual CPU devices the example's own
docstring names (a (freq 4, dof 2) mesh), and ends with one JSON line of
the three training losses and the Gauss-Newton record.

Run from the repository root (~15 min on a loaded 8-core CPU):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python3 .probes/multichip_jax.py
"""
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
path = os.path.join(ROOT, "examples", "multichip.py")
src = open(path).read().replace(":.6e}", "!r}")
lines = []


def echo(*args, **kw):
    text = " ".join(str(a) for a in args)
    lines.append(text)
    print(text, **kw, flush=True)


glb = {"__name__": "__main__", "__file__": path, "print": echo}
exec(compile(src, path, "exec"), glb)
losses = [float(m.group(1)) for t in lines
          if (m := re.match(r"iter \d+: loss=(\S+)$", t))]
gn = [float(m.group(1)) for t in lines
      if (m := re.match(r"GN iter \d+: \|r\|\^2=(\S+) ", t))]
print(json.dumps({"losses": losses, "gn_accepted_rsq": gn,
                  "final_rsq": float(glb["rsq"])}))
sys.exit(0)
