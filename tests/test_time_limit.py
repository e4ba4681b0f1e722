"""The per-phase time limit of `tests/port_fixtures.py`: a test that outlasts
it fails with the limit's message and its stack, within the limit; a test
beside it still passes, on one torch thread; and a module that does not load
the plugin runs without the limit."""

import os
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path


def test_sleeping_test_fails_at_the_time_limit(tmp_path):
    (tmp_path / "test_sleeps.py").write_text(
        "import time\n\nimport torch\n\n"
        'pytest_plugins = ("port_fixtures",)\n\n\n'
        "def test_sleeps():\n"
        "    time.sleep(60)\n\n\n"
        "def test_passes():\n"
        "    assert torch.get_num_threads() == 1\n")
    (tmp_path / "test_unlimited.py").write_text(
        "import time\n\n\n"
        "def test_outlasts_the_limit():\n"
        "    time.sleep(2)\n")
    report = tmp_path / "report.xml"
    env = dict(os.environ, TEST_TIME_LIMIT_S="1",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).parent),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         f"--junitxml={report}", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "1 failed, 2 passed" in out.stdout
    assert "test phase over its time limit of 1 s" in out.stdout
    assert "time.sleep(60)" in out.stdout          # the stuck test's stack
    cases = {case.get("name"): case for case in ET.parse(report).iter("testcase")}
    assert cases["test_sleeps"].find("failure") is not None
    assert cases["test_passes"].find("failure") is None
    assert cases["test_outlasts_the_limit"].find("failure") is None
    # pytest's own time for the stuck test, setup to teardown
    assert float(cases["test_sleeps"].get("time")) < 10
