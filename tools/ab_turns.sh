#!/bin/bash
# Parent and change in turns on one card: K2 stage by stage, then chip_smoke.py.
#
#     bash tools/ab_turns.sh PARENT_DIR [OUT_DIR]
#
# Run from the root of a checkout (the change) on a machine with one CUDA card;
# PARENT_DIR is another checkout, for example `git archive <parent> | tar -x
# -C build/parent`. In the order parent, change, change, parent it runs
# tools/time_mrf_stages.py (this checkout's timing code on each tree's
# matcha_tpu_torch) and then each tree's own chip_smoke.py. Results and logs
# go to OUT_DIR (default chiprun_out/ab); each run's exit code is printed.
set -u
parent=$(cd "$1" && pwd)
out=$(mkdir -p "${2:-chiprun_out/ab}" && cd "${2:-chiprun_out/ab}" && pwd)
here=$(pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"
for run in parent1 change1 change2 parent2; do
  tree=$here; [[ $run == parent* ]] && tree=$parent
  python3 tools/time_mrf_stages.py --tree "$tree" --out "$out/stages_$run.json" \
    > "$out/stages_$run.log" 2>&1
  echo "stages $run rc $?"
done
for run in parent1 change1 change2 parent2; do
  tree=$here; [[ $run == parent* ]] && tree=$parent
  (cd "$tree" && python3 chip_smoke.py --out "$out/cs_$run.json" > "$out/cs_$run.log" 2>&1)
  echo "chip_smoke $run rc $?"
done
