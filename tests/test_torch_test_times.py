"""``scripts/torch_test_times.py`` on a small synthetic junitxml: testcase
time per file and per case, each file's item count and its place in
pytest-xdist's ``--dist loadfile`` order, and the port's share."""

import importlib.util
from pathlib import Path

import pytest

SCRIPT = (Path(__file__).resolve().parents[1] / "scripts"
          / "torch_test_times.py")
_spec = importlib.util.spec_from_file_location("torch_test_times", SCRIPT)
times = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(times)

#: four files: b with the most items goes out first; a and z tie at two
#: items and keep the name order; the skipped case counts
XML = """<?xml version="1.0" encoding="utf-8"?><testsuites><testsuite>
<testcase classname="tests.test_torch_z" name="test_one" time="4.0" />
<testcase classname="tests.test_b" name="test_x[0]" time="1.0" />
<testcase classname="tests.test_torch_a" name="test_p" time="0.5" />
<testcase classname="tests.test_b" name="test_x[1]" time="2.0" />
<testcase classname="tests.test_torch_z" name="test_two" time="6.0" />
<testcase classname="tests.test_b" name="test_x[2]" time="3.0">
<skipped type="pytest.skip" message="needs a CUDA device" /></testcase>
<testcase classname="tests.test_torch_a" name="test_q" time="0.25" />
<testcase classname="tests.test_c" name="test_only" time="8.0" />
</testsuite></testsuites>"""


@pytest.fixture
def xml(tmp_path):
    path = tmp_path / "t1.xml"
    path.write_text(XML)
    return str(path)


def test_per_file_and_loadfile_order(xml):
    files = times.per_file(times.read_cases(xml))
    assert files == {"test_torch_z": (10.0, 2), "test_b": (6.0, 3),
                     "test_torch_a": (0.75, 2), "test_c": (8.0, 1)}
    assert times.loadfile_order(files) == [
        "test_b", "test_torch_a", "test_torch_z", "test_c"]
    assert times.share(files, "test_torch_") == (10.75, 14.0)


def test_report_tables(xml, tmp_path, capsys):
    old = tmp_path / "old.xml"
    old.write_text(XML.replace('time="6.0"', 'time="21.5"'))
    times.main([xml, "--against", str(old), "--cases", "2"])
    out = capsys.readouterr().out.splitlines()
    rows = out[out.index("files (in --dist loadfile order)") + 2:][:4]
    assert [r.split()[:4] for r in rows] == [
        ["1", "3", "6.0", "6.0"], ["2", "2", "0.8", "0.8"],
        ["3", "2", "10.0", "25.5"], ["4", "1", "8.0", "8.0"]]
    # the work handed out ahead of each file
    assert [float(r.split()[4]) for r in rows] == [0.0, 6.0, 6.8, 16.8]
    cases = out[out.index("cases (heaviest 2)") + 2:][:2]
    assert [c.split()[1] for c in cases] == ["test_c::test_only",
                                             "test_torch_z::test_two"]
    share = out[out.index("share") + 1:]
    assert [line.split() for line in share] == [
        ["all", "testcase", "time", "24.8", "s"],
        ["port", "(test_torch_*)", "10.8", "s", "43.4", "%", "of", "all"],
        ["other", "14.0", "s"],
        ["port,", "--against", "run", "26.2", "s", "now", "41.0", "%", "of",
         "it"]]
