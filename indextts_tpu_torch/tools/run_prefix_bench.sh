#!/usr/bin/env bash
# Repeated-prefix serving benchmark on the port: every request shares one
# long text prefix; measures the TTFB effect of cross-request text-prefix
# KV reuse (TARS_PREFIX_REUSE=1) against the same workload without it, one
# process each, merged into the artifact OUT.
#
#   indextts_tpu_torch/tools/run_prefix_bench.sh OUT.json [extra flags...]
#
# CLIENTS (2) and REQUESTS (4) as in tools/run_prefix_bench.sh; extra flags
# (e.g. --device cpu) go to both processes; PYTHON names the interpreter
# (python3).
set -euo pipefail
PY="${PYTHON:-python3}"
OUT="${1:?usage: $0 OUT.json [extra flags]}"
case "$OUT" in /*) ;; *) OUT="$PWD/$OUT" ;; esac
shift
cd "$(dirname "$0")/../.."
CLIENTS="${CLIENTS:-2}"
REQUESTS="${REQUESTS:-4}"

off_json=$(TARS_PREFIX_REUSE=0 "$PY" -m indextts_tpu_torch.tools.bench_server_concurrent \
    --mode sequential --clients "$CLIENTS" --requests "$REQUESTS" \
    --repeat-prefix --port 18655 "$@" | tail -1)
on_json=$(TARS_PREFIX_REUSE=1 "$PY" -m indextts_tpu_torch.tools.bench_server_concurrent \
    --mode sequential --clients "$CLIENTS" --requests "$REQUESTS" \
    --repeat-prefix --port 18656 "$@" | tail -1)

"$PY" - "$OUT" "$off_json" "$on_json" <<'PY'
import json, sys
path, off, on = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {"prefix_reuse_off": off, "prefix_reuse_on": on,
       "ttfb_p50_delta_s": round(off["ttfb_p50_s"] - on["ttfb_p50_s"], 3)}
with open(path, "w") as f:
    json.dump(out, f, indent=1)
print(path, "written:", json.dumps(out))
PY
