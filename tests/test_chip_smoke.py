"""chip_smoke.py refuses to report a result without a GPU."""

import importlib.util
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_fails_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([]) != 0
    assert mod.main(["--four-gpus"]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_alone_in_a_directory_fails(tmp_path):
    """Copied alone into an empty directory, the script exits non-zero
    and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
