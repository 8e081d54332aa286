"""The port stands alone: it imports nothing of the JAX package and no jax.

Each case runs in a child process in which `ais_tpu`, `jax` and `jaxlib`
cannot be imported at all (a meta-path finder raises), so a lazy import
inside a function fails the case as well as one at the top of a module;
afterwards no such name may be in `sys.modules`.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("ais_tpu", "jax", "jaxlib")

PRELUDE = f"""
import sys
FORBIDDEN = {FORBIDDEN!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            raise ImportError(name + ' is blocked: the port stands alone')
sys.meta_path.insert(0, Block())
def check():
    bad = sorted(k for k in sys.modules if k.split('.')[0] in FORBIDDEN)
    assert not bad, bad
    print('ok')
"""

WALK = """
import importlib, pkgutil
import ais_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ais_tpu_torch.__path__, 'ais_tpu_torch.')]
for name in names:
    importlib.import_module(name)
for want in ('core.params', 'ops.firdes', 'utils.bits', 'utils.cpm', 'decode.crc', 'decode.hdlc',
             'decode.nmea', 'decode.fields', 'tx.frame', 'tx.gmsk', 'tx.scenario', 'io.sources',
             'io.rtl_tcp', 'io.grc', 'native'):
    assert 'ais_tpu_torch.' + want in names, want
import chip_smoke
chip_smoke.bench_geometry()
check()
"""

DECODE = """
import dataclasses
import numpy as np
import torch
torch.set_num_threads(1)
from ais_tpu_torch.ops.convert import host_bytes
from ais_tpu_torch.pipeline import wideband as tw
from ais_tpu_torch.tx import aivdm_payload_to_bytes
from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket
cfg = tw.WidebandConfig()
cfg = cfg._replace(demod=dataclasses.replace(cfg.demod, max_bursts_per_block=24), compact_lanes=28)
rx = tw.WidebandReceiver(cfg, n_in=(cfg.block_len - 1) * cfg.decimation + tw.num_taps(cfg),
                         device='cpu')
raw = aivdm_payload_to_bytes('14eG;o@034o8sd<L9i:a;WF>062D')
iq = Scenario(sample_rate=2.4e6, n_samples=rx.n_in, noise=0.004,
              packets=[ScenarioPacket(raw, 200000, -25e3, phase=0.7)]).build()
found = rx.decode_wire(host_bytes((iq * 0.7).astype(np.complex64), 'cr1'), 'cr1')
assert [p.nmea for p in found] == ['!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D'], found
check()
"""

CLI_HELP = """
import contextlib, io
import ais_tpu_torch.cli.ais_rx as cli
buf = io.StringIO()
try:
    with contextlib.redirect_stdout(buf):
        cli.main(['--help'])
except SystemExit as e:
    assert e.code == 0, e.code
assert '--device' in buf.getvalue(), buf.getvalue()
check()
"""


def _run_child(body: str) -> None:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PRELUDE + body], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


@pytest.mark.parametrize("body", [WALK, DECODE, CLI_HELP],
                         ids=["every_module_imports", "cr1_decode_wire", "cli_help"])
def test_port_runs_without_the_reference_package(body):
    _run_child(body)


def test_no_source_file_of_the_port_imports_the_reference_or_jax():
    pattern = re.compile(r"^\s*(from|import)\s+(ais_tpu(\.|\s|$)|jax(lib)?(\.|\s|$))")
    files = [*(REPO / "ais_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(files) > 40
    for src in files:
        for n, line in enumerate(src.read_text().splitlines(), 1):
            assert not pattern.match(line), f"{src}:{n}: {line}"
