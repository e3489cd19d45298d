#!/bin/bash
# The overfit-to-quality proof on one card, from the root of a checkout:
#   bash efficientsam3_tpu_torch/scripts/quality_proof.sh TAG [train_overfit_quality flags...]
# writes the synthetic byte-level BPE file, trains into runs/overfit_TAG,
# scores it into chiprun_out/quality_TAG.json (logs beside it), and prints
# the card's name and power limit, the oracle's and the model's metrics and
# the wall seconds of each part.
set -e
tag=$1; shift
mkdir -p chiprun_out runs
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)"
python -c 'from efficientsam3_tpu_torch.scripts._common import write_byte_level_bpe as w; w("runs/bpe_bytes.txt.gz")'
export EFFICIENTSAM3_BPE_PATH=runs/bpe_bytes.txt.gz
t0=$(date +%s.%N)
python -m efficientsam3_tpu_torch.scripts.train_overfit_quality --out "runs/overfit_$tag" "$@" \
    > "chiprun_out/train_$tag.log" 2>&1 || { tail -50 "chiprun_out/train_$tag.log"; exit 1; }
t1=$(date +%s.%N)
grep -E "^\[detector\] step +[0-9]*(00|50)/|sam-heads\]|fixture|steps" "chiprun_out/train_$tag.log" | tail -40
python -m efficientsam3_tpu_torch.scripts.eval_quality --trained "runs/overfit_$tag" \
    --out "chiprun_out/quality_$tag.json" > "chiprun_out/eval_$tag.log" 2>&1 \
    || { tail -50 "chiprun_out/eval_$tag.log"; exit 1; }
t2=$(date +%s.%N)
python - "$tag" "$t0" "$t1" "$t2" <<'PY'
import json, sys
tag, t0, t1, t2 = sys.argv[1], *map(float, sys.argv[2:])
r = json.load(open(f"chiprun_out/quality_{tag}.json"))
print(json.dumps(r["harness_oracle"]["perfect"]))
print(json.dumps(r["model"]))
print("train_s", t1 - t0, "eval_s", t2 - t1)
PY
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
