#!/bin/bash
# Robust04-shape protocol rehearsal on the PyTorch port: synthesize a
# 524,288-document multi-index Indri repository (scripts/make_adhoc_fixture.py
# through scripts/make_adhoc_fixture_torch.py, 4 indexes, from --gen_seed
# 12345), then run scripts/rank_adhoc_torch.py on it end to end: multi-index
# ingestion, on-device sampled training at full width with bfloat16 streams,
# validation every 3 epochs, a simulated crash after epoch 6 and a --resume
# run that finishes the 12 epochs.  Writes
# results/rehearse_adhoc_h100.json: the protocol's results.json, the card's
# name and power limit, the wall time of each stage, and each epoch's
# seconds and ms/step with the seconds between it and the next (the
# checkpoint write and the validation).  scripts/rehearse_adhoc.sh is the
# JAX package's version of the same two stages.
#
# Usage: bash scripts/rehearse_adhoc_torch.sh [root] [workdir] [flags...]
#   root defaults to build/adhoc500k and workdir to build/adhoc500k_wd (under
#   the checkout); flags are appended to both stages' (e.g. --device cpu).
#   NUM_DOCS (default 524288) sizes a new fixture; RECORD (default
#   results/rehearse_adhoc_h100.json) is the record written.
set -x
cd "$(dirname "$0")/.."
ROOT=${1:-build/adhoc500k}
WD=${2:-build/adhoc500k_wd}
shift 2 2>/dev/null || shift $#
NUM_DOCS=${NUM_DOCS:-524288}
RECORD=${RECORD:-results/rehearse_adhoc_h100.json}

if [ ! -f "$ROOT/fixture.json" ]; then
  python3 scripts/make_adhoc_fixture_torch.py --root "$ROOT" \
      --num_docs "$NUM_DOCS" --num_indexes 4 || exit 1
fi

mkdir -p "$WD"
COMMON=(--corpus "$ROOT/repository" --topics "$ROOT/topics.txt"
        --qrels "$ROOT/qrels.txt" --splits "$ROOT/splits" --workdir "$WD"
        --num_epochs 12 --eval_every 3 --checkpoint_every 3
        --batch_size 51200 --on_device_sampling --steps_per_call 71
        --stream_dtype bfloat16 --window_sum_dtype bfloat16 "$@")

# Stage 1: train to epoch 6, then a simulated crash.
T0=$(date +%s.%N)
python3 scripts/rank_adhoc_torch.py "${COMMON[@]}" --fail_after_epoch 6 \
    2>&1 | tee "$WD/stage1.log"
echo "stage 1 exited with ${PIPESTATUS[0]} (expected nonzero: simulated crash)"
T1=$(date +%s.%N)

# Stage 2: resume from the last dumped epoch and finish the protocol.
python3 scripts/rank_adhoc_torch.py "${COMMON[@]}" --resume \
    2>&1 | tee "$WD/stage2.log"
[ "${PIPESTATUS[0]}" -eq 0 ] || exit 1
T2=$(date +%s.%N)

python3 - "$ROOT" "$WD" "$RECORD" "$T0" "$T1" "$T2" <<'EOF' || exit 1
import datetime
import json
import re
import subprocess
import sys

root, wd, record, t0, t1, t2 = sys.argv[1:4] + [float(t) for t in sys.argv[4:]]
with open(f"{wd}/results.json") as f:
    out = json.load(f)
with open(f"{root}/fixture.json") as f:
    out["fixture"] = json.load(f)
try:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
except OSError:
    smi = "not measured: no nvidia-smi"
out["nvidia_smi"] = smi
out["stage_wall_s"] = [t1 - t0, t2 - t1]


def stamp(line):
    return datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()


epoch_re = re.compile(r"Epoch (\d+)[^:]*: cost=([0-9.eE+-]+) \((\d+) steps, ([0-9.]+)s\)")
val_re = re.compile(r"Epoch (\d+) validation MAP = [0-9.]+ \(([0-9.]+)s\)")
epochs, validation_s = [], {}
for stage in (1, 2):
    with open(f"{wd}/stage{stage}.log") as f:
        for line in f:
            m = epoch_re.search(line)
            if m:
                epochs.append(dict(stage=stage, epoch=int(m[1]), cost=float(m[2]), steps=int(m[3]),
                                   seconds=float(m[4]), ms_per_step=1e3 * float(m[4]) / int(m[3]),
                                   logged_at=stamp(line)))
            m = val_re.search(line)
            if m:
                validation_s[int(m[1])] = float(m[2])
# The time between an epoch's end and the next epoch's start (same stage):
# the snapshot of a dump, the wait for the checkpoint writer and the
# validation.
for e, nxt in zip(epochs, epochs[1:]):
    if nxt["stage"] == e["stage"]:
        e["after_epoch_s"] = nxt["logged_at"] - nxt["seconds"] - e["logged_at"]
for e in epochs:
    e["validation_s"] = validation_s.get(e["epoch"])
    del e["logged_at"]
out["epochs"] = epochs
with open(record, "w") as f:
    json.dump(out, f, indent=2, sort_keys=True)
print(json.dumps(out, sort_keys=True))
EOF
echo REHEARSAL-DONE
