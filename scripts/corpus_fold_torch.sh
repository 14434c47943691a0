#!/bin/bash
# Relaunching single-fold runner of the corpus protocol for the PyTorch port.
#
# Runs `python -m cova_tpu_torch.cli train` on fold FOLD of the corpus clone
# (scripts/make_corpus_clone_torch.py) and relaunches it with --resume while
# it exits non-zero, up to ATTEMPTS times. The trainer saves "last" (model,
# optimizer, epoch, patience) every epoch and --resume continues the exact
# dropout and shuffle stream, so a cut run loses at most one epoch. Attempt 1
# also passes --resume: with no checkpoint it trains fresh.
#
# Every 30 seconds it appends the train process's VmRSS to
# $OUT/fold<FOLD>_rss.txt with the epochs logged so far, so the host RSS
# curve per epoch is on disk. The RSS watchdog (cova_tpu_torch/utils/rss.py)
# re-execs the same process, so the samples go on under the same pid.
#
# Usage: scripts/corpus_fold_torch.sh FOLD [extra cli-train args...]
#   env: CLONE (.corpus_clone), OUT (artifacts/corpus_torch_h100),
#        IMGH (512), ATTEMPTS (4)
set -u
cd "$(dirname "$0")/.."
CLONE=${CLONE:-.corpus_clone}
OUT=${OUT:-artifacts/corpus_torch_h100}
IMGH=${IMGH:-512}
ATTEMPTS=${ATTEMPTS:-4}
f=$1; shift
mkdir -p "$OUT"
LOG="$OUT/fold${f}_console.log"
RSS="$OUT/fold${f}_rss.txt"

: > "$LOG"
if command -v nvidia-smi > /dev/null; then
  echo "card: $(nvidia-smi --query-gpu=name,power.limit \
    --format=csv,noheader | head -1)" | tee -a "$LOG"
fi
echo "# seconds attempt pid epochs_logged vmrss_kb" > "$RSS"

t0=$(date +%s)
rc=1
for attempt in $(seq 1 "$ATTEMPTS"); do
  echo "=== Fold-$f attempt $attempt (corpus-scale train, ${IMGH}px) ===" \
    | tee -a "$LOG"
  python -m cova_tpu_torch.cli train \
    --data_dir "$CLONE" -cvf "$f" --img_height "$IMGH" \
    --output_dir "$OUT" --decode_cache "${TMPDIR:-/tmp}/cova_decode_torch_$IMGH" \
    --resume "$@" > >(tee -a "$LOG") 2>&1 &
  pid=$!
  next=0
  while kill -0 "$pid" 2> /dev/null; do
    now=$(date +%s)
    if [ "$now" -ge "$next" ]; then
      kb=$(awk '/^VmRSS/ {print $2}' "/proc/$pid/status" 2> /dev/null)
      ep=$(grep -c '^Epoch:' "$LOG")
      [ -n "$kb" ] && echo "$((now - t0)) $attempt $pid $ep $kb" >> "$RSS"
      next=$((now + 30))
    fi
    sleep 1
  done
  wait "$pid"
  rc=$?
  echo "rc=$rc fold$f attempt $attempt" | tee -a "$LOG"
  [ "$rc" -eq 0 ] && break
done
exit $rc
