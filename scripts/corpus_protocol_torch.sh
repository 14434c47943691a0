#!/bin/bash
# The verbatim fold protocol at corpus scale through the PyTorch port.
#
# Counterpart of scripts/corpus_protocol.sh. The real dataset is not in the
# repository, so this runs on the corpus clone: one hard-mode page per real
# page id of splits/all_imgs.txt (7,740 pages, 408 domains), written by
# scripts/make_corpus_clone_torch.py if CLONE has none. Then, in order:
#   1. each fold through scripts/corpus_fold_torch.sh (train with relaunch
#      and RSS samples; the verbatim splits/Fold-k lists, the 408-domain
#      macro report);
#   2. when 1 is among the folds, `cli eval` of Fold-1's best checkpoint,
#      reports in $OUT/eval_fold1/;
#   3. then `cli visualize --max_pages 3` from Fold-1; one attention CSV and
#      PNG are copied to $OUT/attn_corpus_page.{csv,png};
#   4. the per-fold Bayes-oracle band (scripts/corpus_oracle_summary.py);
#   5. the published-table aggregation over the folds that have rows.
#
# Usage: scripts/corpus_protocol_torch.sh [fold ...]   (default: 1 2 3 4 5)
#   env: CLONE (.corpus_clone), OUT (artifacts/corpus_torch_h100), IMGH
#        (512), SPLITS (splits), DEVICE (cuda), TRAIN_ARGS (extra args of
#        train, eval and visualize: the model's flags must agree)
set -u
cd "$(dirname "$0")/.."
ROOT=$PWD
CLONE=${CLONE:-.corpus_clone}
OUT=${OUT:-artifacts/corpus_torch_h100}
IMGH=${IMGH:-512}
SPLITS=${SPLITS:-splits}
DEVICE=${DEVICE:-cuda}
FOLDS=${*:-1 2 3 4 5}
mkdir -p "$OUT"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

if [ ! -f "$CLONE/corpus_oracle.csv" ]; then
  echo "=== generating corpus clone ($CLONE, ${IMGH}px) ==="
  python scripts/make_corpus_clone_torch.py --out "$CLONE" \
    --img_height "$IMGH" --splits "$SPLITS" || exit 1
fi

rc=0
for f in $FOLDS; do
  echo "=== Fold-$f: corpus-scale train (reference defaults, ${IMGH}px) ==="
  # shellcheck disable=SC2086
  CLONE="$CLONE" OUT="$OUT" IMGH="$IMGH" \
    scripts/corpus_fold_torch.sh "$f" --split_dir "$SPLITS" \
    --device "$DEVICE" ${TRAIN_ARGS:-} | tail -40
  s=${PIPESTATUS[0]}; rc=$((rc | s)); echo "rc=$s done fold$f"
done

# Fold-1's checkpoint exists only where this call trained Fold-1: a call for
# other folds leaves Fold-1's eval and visualize reports as they are.
if [[ " $FOLDS " == *" 1 "* ]]; then
  echo "=== Fold-1 eval of the best checkpoint (cli eval) ==="
  # eval writes its reports into its working directory.
  mkdir -p "$OUT/eval_fold1"
  ABS=(--data_dir "$(cd "$CLONE" && pwd)" --split_dir "$(cd "$SPLITS" && pwd)"
       --output_dir "$(cd "$OUT" && pwd)")
  # shellcheck disable=SC2086
  (cd "$OUT/eval_fold1" && python -m cova_tpu_torch.cli eval "${ABS[@]}" \
     -cvf 1 --img_height "$IMGH" --device "$DEVICE" ${TRAIN_ARGS:-}) 2>&1 \
    | tee "$OUT/eval_fold1_console.log" | tail -15
  echo "rc=${PIPESTATUS[0]} done eval"

  echo "=== Fold-1 attention visualization (cli visualize, 3 pages) ==="
  # The overlays need matplotlib; without it only the attention CSVs are
  # written (render them elsewhere: utils/visualize.py:visualize_bbox).
  RENDER=""
  python -c "import matplotlib" 2> /dev/null || RENDER=--no_render
  # shellcheck disable=SC2086
  python -m cova_tpu_torch.cli visualize --data_dir "$CLONE" \
    --split_dir "$SPLITS" -cvf 1 --img_height "$IMGH" --device "$DEVICE" \
    --output_dir "$OUT" --max_pages 3 $RENDER ${TRAIN_ARGS:-} 2>&1 \
    | tee "$OUT/visualize_console.log" | tail -15
  echo "rc=${PIPESTATUS[0]} done visualize"
  VIZ=$(ls -d "$OUT"/*/"Fold-1 attention visualization" 2> /dev/null | head -1)
  if [ -n "$VIZ" ]; then
    cp "$(ls "$VIZ"/*.csv | head -1)" "$OUT/attn_corpus_page.csv"
    PNG=$(ls "$VIZ"/*.png 2> /dev/null | head -1)
    [ -n "$PNG" ] && cp "$PNG" "$OUT/attn_corpus_page.png"
  fi
fi

echo "=== per-fold Bayes-oracle ceilings over the verbatim test lists ==="
# shellcheck disable=SC2046
python scripts/corpus_oracle_summary.py --clone "$CLONE" --splits "$SPLITS" \
  --folds $(ls -d "$SPLITS"/Fold-* | sed 's/.*Fold-//') | tee "$OUT/oracle_summary.txt"

# Published-table aggregation over whatever folds have rows so far.
python - "$OUT" <<'PY'
import glob, os, sys
from cova_tpu_torch.cli import sweep_summary
for p in glob.glob(os.path.join(sys.argv[1], "*", "fold_wise_acc.csv")):
    s = sweep_summary(p, [1, 2, 3, 4, 5])
    if s:
        print(f"--- {p} ---\n{s}", end="")
        with open(os.path.join(os.path.dirname(p), "sweep_summary.txt"),
                  "w") as f:
            f.write(s)
PY
exit $rc
