#!/usr/bin/env bash
# The port's dry-run of every cell on one production mesh, each cell in a
# process of its own under a time limit, then a table of the records.
#
#   tools/torch_dryrun_cells.sh [OUT] [JOBS] [LIMIT_S] [--multi-pod]
#
# OUT (default artifacts/dryrun_torch_cells) receives single/ (or multi/)
# records and one log a cell; JOBS cells run at once (default 4); a cell
# still counting after LIMIT_S seconds (default 1200) is cut and listed.
# Needs no card: the dry-run counts on meta.
set -u
OUT=${1:-artifacts/dryrun_torch_cells}
JOBS=${2:-4}
LIMIT=${3:-1200}
MESH=${4:-}
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} CUDA_VISIBLE_DEVICES=""
mkdir -p "$OUT/logs"
python -c "from repro_torch.configs.base import cells
for a, s, _ in cells(): print(a, s)" |
  xargs -P "$JOBS" -L 1 sh -c '
    t0=$(date +%s); timeout '"$LIMIT"' python -m repro_torch.launch.dryrun --arch "$0" \
      --shape "$1" --out '"$OUT"' '"$MESH"' > '"$OUT"'/logs/"$0__$1".log 2>&1
    echo "$0 $1 rc=$? wall=$(( $(date +%s) - t0 ))s"'
python - "$OUT" "${MESH:+multi}" <<'PY'
import json, os, sys
from repro_torch.configs.base import cells
out, tag = sys.argv[1], sys.argv[2] or "single"
print("| cell | peak GiB/dev | hbm_fit | collective operand GB/dev | count_s |")
print("| --- | --- | --- | --- | --- |")
for arch, shape, _ in cells():
    path = os.path.join(out, tag, f"{arch}__{shape}.json")
    if not os.path.exists(path):
        print(f"| {arch} {shape} | no record (cut or failed: see logs/) | | | |")
        continue
    r = json.load(open(path))
    print(f"| {arch} {shape} | {r['memory']['peak_bytes_per_device'] / 2**30:.2f} | "
          f"{r['hbm_fit']} | {r['collectives']['total_operand'] / 1e9:.3f} | {r['count_s']} |")
PY
