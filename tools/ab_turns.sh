#!/bin/bash
# Parent and change in turns on one card: the timing tools, then chip_smoke.py.
#
#     bash tools/ab_turns.sh PARENT_DIR [OUT_DIR] [STEPS]
#
# Run from the root of a checkout (the change) on a machine with one CUDA card;
# PARENT_DIR is another checkout, for example `git archive <parent> | tar -x
# -C build/parent`. STEPS (default "mrf mas chip_smoke") picks, in that order:
#   mrf         tools/time_mrf_stages.py, K2 stage by stage;
#   mas         tools/time_mas.py, whole maximum_path calls at the training
#               path's shapes;
#   serve       tools/time_serve.py, the serving engine's two request kinds;
#   train       tools/time_train.py, training micro-steps (eager, and graph
#               replays where the tree has them);
#   chip_smoke  each tree's own chip_smoke.py.
# Each step runs in the order parent, change, change, parent; the timing tools
# run this checkout's timing code on each tree's matcha_tpu_torch. Results and
# logs go to OUT_DIR (default chiprun_out/ab); each run's exit code is printed.
set -u
parent=$(cd "$1" && pwd)
out=$(mkdir -p "${2:-chiprun_out/ab}" && cd "${2:-chiprun_out/ab}" && pwd)
steps=${3:-mrf mas chip_smoke}
here=$(pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$out/card.txt"
for step in $steps; do
  for run in parent1 change1 change2 parent2; do
    tree=$here; [[ $run == parent* ]] && tree=$parent
    case $step in
      mrf) python3 tools/time_mrf_stages.py --tree "$tree" --out "$out/stages_$run.json" \
             > "$out/stages_$run.log" 2>&1 ;;
      mas) python3 tools/time_mas.py --tree "$tree" --out "$out/mas_$run.json" \
             > "$out/mas_$run.log" 2>&1 ;;
      serve) python3 tools/time_serve.py --tree "$tree" --out "$out/serve_$run.json" \
               > "$out/serve_$run.log" 2>&1 ;;
      train) python3 tools/time_train.py --tree "$tree" --out "$out/train_$run.json" \
               > "$out/train_$run.log" 2>&1 ;;
      chip_smoke) (cd "$tree" && python3 chip_smoke.py --out "$out/cs_$run.json" \
                    > "$out/cs_$run.log" 2>&1) ;;
      *) echo "unknown step $step"; exit 2 ;;
    esac
    echo "$step $run rc $?"
  done
done
