"""Where the Tier-1 test run spends its time, read from its junitxml.

    python3 scripts/torch_test_times.py /tmp/_t1.xml [--against OLD.xml]
        [--cases 25] [--prefix test_torch_]

Prints three tables:

- ``files``: each test file's summed testcase time, its item count, and
  its place in pytest-xdist's ``--dist loadfile`` order: xdist hands out
  whole files, those with the most items first, ties in collection order
  (file name order under ``tests/``), so a file's place says how much
  work the six workers take before it;
- ``cases``: the ``--cases`` heaviest testcases;
- ``share``: the port's files (``--prefix``) against the rest, in
  seconds and in percent of all testcase time.

With ``--against`` each file's time in the older run stands beside the
new one, and the share table gives both totals and their ratio.
Skipped cases count as items (xdist schedules them) and their time counts.
"""

from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def read_cases(path):
    """``[(file stem, case name, seconds)]`` of every testcase in the XML."""
    cases = []
    for case in ET.parse(path).getroot().iter("testcase"):
        module = case.get("classname", "").split(".")
        stem = next((p for p in module if p.startswith("test_")), module[-1])
        cases.append((stem, case.get("name", ""),
                      float(case.get("time", 0.0))))
    return cases


def per_file(cases):
    """``{file stem: (seconds, items)}``."""
    seconds = collections.defaultdict(float)
    items = collections.Counter()
    for stem, _, t in cases:
        seconds[stem] += t
        items[stem] += 1
    return {stem: (seconds[stem], items[stem]) for stem in items}


def loadfile_order(files):
    """The file stems in the order ``--dist loadfile`` hands them out."""
    return sorted(sorted(files), key=lambda stem: -files[stem][1])


def share(files, prefix):
    """``(port seconds, other seconds)``."""
    port = sum(t for stem, (t, _) in files.items() if stem.startswith(prefix))
    return port, sum(t for t, _ in files.values()) - port


def report(path, against=None, n_cases=25, prefix="test_torch_"):
    """The three tables as one string."""
    cases = read_cases(path)
    files = per_file(cases)
    old = per_file(read_cases(against)) if against else {}
    order = loadfile_order(files)
    lines = ["files (in --dist loadfile order)",
             "place  items  seconds  before_s  work_ahead_s  file"]
    ahead = 0.0
    for place, stem in enumerate(order, 1):
        t, n = files[stem]
        was = f"{old[stem][0]:8.1f}" if stem in old else "       -"
        lines.append(f"{place:5d}  {n:5d}  {t:7.1f}  {was}  {ahead:12.1f}"
                     f"  {stem}")
        ahead += t
    lines += ["", f"cases (heaviest {n_cases})", "seconds  case"]
    for stem, name, t in sorted(cases, key=lambda c: -c[2])[:n_cases]:
        lines.append(f"{t:7.1f}  {stem}::{name}")
    port, rest = share(files, prefix)
    total = port + rest
    lines += ["", "share", f"{'all testcase time':<24}{total:9.1f} s",
              f"{f'port ({prefix}*)':<24}{port:9.1f} s  "
              f"{percent(port, total):5.1f} % of all",
              f"{'other':<24}{rest:9.1f} s"]
    if old:
        old_port, _ = share(old, prefix)
        lines.append(f"{'port, --against run':<24}{old_port:9.1f} s  now "
                     f"{percent(port, old_port):5.1f} % of it")
    return "\n".join(lines)


def percent(part, whole):
    return 100.0 * part / whole if whole else 0.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("xml")
    parser.add_argument("--against", default=None)
    parser.add_argument("--cases", type=int, default=25)
    parser.add_argument("--prefix", default="test_torch_")
    args = parser.parse_args(argv)
    print(report(args.xml, args.against, args.cases, args.prefix))


if __name__ == "__main__":
    main()
