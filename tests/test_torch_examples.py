"""The port's examples and serving CLI on the CPU.

Each example of ``src/repro_torch/examples`` runs at its own size with
``--device cpu``, and what it prints must equal what the repository's JAX
example prints, line for line, once the timings are masked: quickstart's
rounds, work, validity and PageRank error; atos_tradeoffs' work/|V|,
rounds and dispatches (its heatmap's cells are timings only);
serve_continuous' schedule and active-slot trace.  The JAX examples run
once, in one subprocess that starts with the module (``jax_output``), and
their output is masked alike.  The serving CLI runs for every architecture of the registry at its smoke
size, with the reference's default requests and slots.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro_torch.configs import smoke_config
from repro_torch.examples import atos_tradeoffs, quickstart, serve_continuous
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import synthetic_requests

from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

PORT = {"quickstart": quickstart.main, "atos_tradeoffs": atos_tradeoffs.main,
        "serve_continuous": serve_continuous.main}
#: timing fields, masked: the wall clock and the heatmap's cells
TIMINGS = [(re.compile(r"wall=\s*[0-9.]+ ms"), "wall=* ms"),
           (re.compile(r"^(w=\d+)\s.*$"), r"\1 *")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: runs each of the JAX examples as ``__main__`` and prints their standard
#: outputs as one JSON object, by name
_REFERENCE = """
import contextlib, io, json, runpy, sys
out = {}
for name in sys.argv[1:]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(f"examples/{name}.py", run_name="__main__")
    out[name] = buf.getvalue()
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_proc(tmp_path_factory):
    """Start the JAX examples in one subprocess as the module starts, so
    they run beside the in-process tests; :func:`jax_output` waits."""
    out = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    with open(out / "stdout", "w") as so, open(out / "stderr", "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, *PORT], cwd=REPO,
            stdout=so, stderr=se, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_output(_reference_proc):
    """Each JAX example's standard output, its timings masked."""
    proc, out = _reference_proc
    assert proc.wait(timeout=600) == 0, (out / "stderr").read_text()[-3000:]
    text = json.loads((out / "stdout").read_text().strip().splitlines()[-1])
    return {name: _masked(t) for name, t in text.items()}


def _masked(text: str) -> list:
    lines = []
    for line in text.splitlines():
        for pattern, repl in TIMINGS:
            line = pattern.sub(repl, line)
        lines.append(line)
    return lines


@pytest.mark.parametrize("name", list(PORT))
def test_example_default_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT[name]([])


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_serve_cli_serves_every_arch_on_the_cpu(arch, capsys):
    """``--arch <a> --smoke --device cpu`` (for olmoe-1b-7b the reference's
    own usage line, on the CPU): every request gets its tokens and the
    continuous schedule fills the slots."""
    serve_main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mode=continuous requests=16 slots=4 device=cpu" in out
    want = sum(r.max_new_tokens for r in synthetic_requests(
        16, smoke_config(arch).vocab_size))
    assert f"tokens={want} " in out
    assert re.search(r"wavefronts=\d+ mean_occupancy=0\.\d+", out)


@pytest.mark.parametrize("name", list(PORT))
def test_example_prints_what_the_jax_example_prints(name, request):
    """Last in the module, and the port's run before the wait, so that the
    JAX subprocess runs beside the tests above."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        PORT[name](["--device", "cpu"])
    assert _masked(buf.getvalue()) == request.getfixturevalue(
        "jax_output")[name]
