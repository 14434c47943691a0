#!/bin/bash
# One traced steady epoch of the corpus path at 512^2 through the PyTorch port.
#
# Fold-1 of the corpus clone cut to prefixes of its real lists (SPLIT: 500
# train, 50 val, 50 test pages, with their domains; fold_subset of
# scripts/make_corpus_clone_torch.py), those pages cloned at IMGH, then at
# the flagship's widths (bf16, B = 5, plus TRAIN_ARGS):
#   1. `cli train -e 1`: decodes every page into the decode cache;
#   2. `COVA_PROFILE_DIR=$TRACE cli train -e 2 --resume`: the trainer traces
#      epoch 2 (100 steps, the decode cache warm) and not its eval;
#   3. `cli train -e 3 --resume` without the hook: the same 100 steps'
#      seconds untraced, beside the traced epoch's (the profiler's cost);
#   4. scripts/read_torch_trace.py on that trace -> $OUT/trace_summary.json.
# The trace itself (tens of MB) stays in TRACE. Both defaults lie under
# profile_traces/, which git ignores.
#
# Usage: scripts/profile_corpus_epoch_torch.sh
#   env: OUT (profile_traces/corpus_epoch), TRACE
#        (profile_traces/corpus_epoch_trace), IMGH (512), SPLIT ("500 50 50"),
#        DEVICE (cuda), TRAIN_ARGS
set -eu
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
OUT=${OUT:-profile_traces/corpus_epoch}
TRACE=${TRACE:-profile_traces/corpus_epoch_trace}
IMGH=${IMGH:-512}
SPLIT=${SPLIT:-500 50 50}
DEVICE=${DEVICE:-cuda}
rm -rf "$OUT" "$TRACE"
mkdir -p "$OUT"

# shellcheck disable=SC2086
python - "$OUT/splits" $SPLIT <<'PY'
import runpy, sys
sub = runpy.run_path("scripts/make_corpus_clone_torch.py")["fold_subset"]
out, *n = sys.argv[1:]
print(len(sub("splits", out, 1, *map(int, n))), "pages")
PY
python scripts/make_corpus_clone_torch.py --out "$OUT/clone" \
  --img_height "$IMGH" --splits "$OUT/splits" --no-oracle | tail -1

ARGS=(--data_dir "$OUT/clone" --split_dir "$OUT/splits" -cvf 1
      --img_height "$IMGH" --device "$DEVICE" --output_dir "$OUT/results"
      --decode_cache "$OUT/decode_cache")
# shellcheck disable=SC2086
python -m cova_tpu_torch.cli train "${ARGS[@]}" -e 1 ${TRAIN_ARGS:-} \
  2>&1 | tee "$OUT/epoch1_console.log" | grep '^Epoch:'
# shellcheck disable=SC2086
COVA_PROFILE_DIR="$TRACE" python -m cova_tpu_torch.cli train "${ARGS[@]}" \
  -e 2 --resume ${TRAIN_ARGS:-} 2>&1 | tee "$OUT/epoch2_console.log" \
  | grep '^Epoch:\|^Resuming'
# shellcheck disable=SC2086
python -m cova_tpu_torch.cli train "${ARGS[@]}" -e 3 --resume ${TRAIN_ARGS:-} \
  2>&1 | tee "$OUT/epoch3_console.log" | grep '^Epoch:\|^Resuming'
python scripts/read_torch_trace.py "$TRACE" | tee "$OUT/trace_summary.json"
rm -rf "$OUT/clone" "$OUT/decode_cache" "$OUT/results"/*/*saved_model.pt
