"""Update check (Check_version, src/utils/check_version.cpp:35-90).

The reference curls the upstream VERSION_HISTORY from GitHub when run
with --version and prints every entry newer than its own version. Same
here via urllib with a short timeout; offline/air-gapped runs degrade
to a one-line notice (the reference would block and fail in curl).
"""
from __future__ import annotations

import re
import sys

VERSION_HISTORY_URL = ("https://raw.githubusercontent.com/ariloytynoja/"
                       "pagan-msa/master/VERSION_HISTORY")


def check_version(current: float, timeout: float = 4.0) -> None:
    print("Checking if updates are available at "
          "https://github.com/ariloytynoja/pagan-msa.", file=sys.stderr)
    try:
        from urllib.request import urlopen
        with urlopen(VERSION_HISTORY_URL, timeout=timeout) as r:
            text = r.read().decode("utf-8", "replace")
    except Exception as e:
        print("update check failed (%s) — no network access?"
              % e.__class__.__name__, file=sys.stderr)
        return
    printing = False
    newer = False
    for line in text.splitlines():
        m = re.match(r"^v\.?(\d+(?:\.\d+)?)", line.strip())
        if m:
            printing = float(m.group(1)) > current
            newer = newer or printing
        if printing:
            print(line, file=sys.stderr)
    if not newer:
        print("You have the latest version.", file=sys.stderr)
