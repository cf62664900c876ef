#!/usr/bin/env bash
# fhh-lint strict run over the PyTorch/CUDA port, with a machine-readable
# artifact.  The twin of scripts/lint.sh (which lints the JAX package).
#
# Usage: scripts/lint_torch.sh [artifact.json]
#   - exits 0 iff the port has ZERO non-baselined findings (any severity)
#     under lint_torch.toml and lint_baseline_torch.json
#   - writes the JSON report to $1 (default: lint_report_torch.json)
#
# The same check runs inside tier-1 via tests/test_torch_analysis.py's
# self-lint test; this script is the standalone/CI entry point.
set -euo pipefail
cd "$(dirname "$0")/.."

artifact="${1:-lint_report_torch.json}"

rc=0
python -m fuzzyheavyhitters_torch.analysis \
    fuzzyheavyhitters_torch tests/test_torch_*.py tests/torch_*.py \
    chip_smoke.py scripts/live_cost.py scripts/socket_ab.py scripts/nvcc_split_check.py \
    scripts/gc_ab.py scripts/ot2s_ab.py scripts/kernel_ab.py scripts/ot2s_sector_probe.py \
    --strict --format json > "$artifact" || rc=$?

python - "$artifact" <<'PY'
import json, sys
doc = json.load(open(sys.argv[1]))
# the artifact must prove the interprocedural fhh-race AND fhh-taint
# passes ran (the rule list is part of the report schema exactly for
# this assert)
race = {"guarded-state-unlocked", "stale-read-across-await"}
taint = {"secret-to-sink-flow", "secret-branch", "unmasked-wire"}
missing = (race | taint) - set(doc.get("rules", []))
if missing:
    print(f"fhh-lint: interprocedural pass MISSING from artifact: {sorted(missing)}")
    sys.exit(1)
print(
    f"fhh-lint: {len(doc['findings'])} new, "
    f"{doc['baselined']} baselined, "
    f"{len(doc['stale_baseline'])} stale baseline entries, "
    f"{len(doc['rules'])} rules, fhh-race + fhh-taint passes active "
    f"-> {sys.argv[1]}"
)
PY
exit $rc
