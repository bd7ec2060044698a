#!/bin/bash
# Times each port test file (tests/test_torch_*.py) of two checkouts side by
# side: for every file, the other checkout's copy and this one's run at the
# same moment, one pytest process each, so both see the same host load.  A
# file that only one checkout has runs alone.
#
#   scripts/port_test_times.sh OTHER_CHECKOUT [OUT]
#
# One line per file: "file | other SECONDS RESULT | this SECONDS RESULT".
set -u
other=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
out=${2:-/dev/stdout}
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
run() {  # checkout file -> "seconds result"
  local s e r
  s=$(date +%s.%N)
  r=$(cd "$1" && env JAX_PLATFORMS=cpu timeout 1200 python -m pytest "$2" -q \
      -p no:cacheprovider -p no:randomly 2>&1 | tail -1)
  e=$(date +%s.%N)
  echo "$(python3 -c "print(round($e - $s, 1))") $r"
}
files=$( (cd "$here" && ls tests/test_torch_*.py; cd "$other" && ls tests/test_torch_*.py) | sort -u)
for f in $files; do
  [ -f "$other/$f" ] && run "$other" "$f" > "$tmp/o" &
  [ -f "$here/$f" ] && run "$here" "$f" > "$tmp/h" &
  wait
  echo "$f | other $(cat "$tmp/o" 2>/dev/null || echo -) | this $(cat "$tmp/h" 2>/dev/null || echo -)" >> "$out"
  rm -f "$tmp/o" "$tmp/h"
done
