#!/usr/bin/env bash
# Multi-client serving benchmark on the port: runs the sequential and the
# continuous mode (one process each: the engine owns the card) and merges
# their JSON lines into the artifact OUT.
#
#   indextts_tpu_torch/tools/run_server_bench.sh OUT.json [extra flags...]
#
# CLIENTS (4), REQUESTS (3) and SEGMENTS (4; >1 separates streaming TTFB
# from total) as in tools/run_server_bench.sh; extra flags (e.g.
# --device cpu) go to both processes; PYTHON names the interpreter
# (python3).
set -euo pipefail
PY="${PYTHON:-python3}"
OUT="${1:?usage: $0 OUT.json [extra flags]}"
case "$OUT" in /*) ;; *) OUT="$PWD/$OUT" ;; esac
shift
cd "$(dirname "$0")/../.."
CLIENTS="${CLIENTS:-4}"
REQUESTS="${REQUESTS:-3}"
SEGMENTS="${SEGMENTS:-4}"

seq_json=$("$PY" -m indextts_tpu_torch.tools.bench_server_concurrent --mode sequential \
    --clients "$CLIENTS" --requests "$REQUESTS" \
    --segments "$SEGMENTS" --blocking-pass "$@" | tail -1)
cont_json=$(TARS_CONTINUOUS_SLOTS="$CLIENTS" \
    "$PY" -m indextts_tpu_torch.tools.bench_server_concurrent --mode continuous \
    --clients "$CLIENTS" --requests "$REQUESTS" \
    --segments "$SEGMENTS" --blocking-pass "$@" | tail -1)

"$PY" - "$OUT" "$seq_json" "$cont_json" <<'PY'
import json, sys
path, seq, cont = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {"sequential": seq, "continuous": cont,
       "speedup_aggregate": round(
           cont["aggregate_audio_s_per_s"] / seq["aggregate_audio_s_per_s"], 2)}
with open(path, "w") as f:
    json.dump(out, f, indent=1)
print(path, "written:", json.dumps(out))
PY
