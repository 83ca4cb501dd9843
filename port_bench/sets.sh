#!/bin/bash
# Measure cells as BENCHMARK.json's bounds ask, on a machine with the card, from the
# checkout's root: two sets of six runs with the same seeds, three traced runs, then
# the controls (port_bench/control.py) on three more seeds; each run's output kept in
# OUTDIR, which port_bench/spreads.py reads.
#   bash port_bench/sets.sh OUTDIR SECONDS CELL...
# SEED_OFFSET (default 0) shifts every seed, so that a new measurement draws new ones.
O=$1; SEC=$2; shift 2; mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
for w in "$@"; do
  h=$(python3 -c "import zlib, sys; print(zlib.crc32(sys.argv[1].encode()) % 1000)" "$w")
  base=$((3000000000 + h * 1000 + ${SEED_OFFSET:-0}))
  for set in A B; do
    for i in 1 2 3 4 5 6; do
      s=$((base + i))
      python3 port_bench/run.py --workload "$w" --seed $s --seconds "$SEC" --trace 0 \
        > "$O/$w.$set$i.out" 2> "$O/$w.$set$i.err"
      echo "$w $set$i seed=$s rc=$? $(tail -n 1 "$O/$w.$set$i.out" | cut -c1-200)"
    done
  done
  for i in 1 2 3; do
    s=$((base + 100 + i))
    python3 port_bench/run.py --workload "$w" --seed $s --seconds "$SEC" --trace 1 \
      > "$O/$w.T$i.out" 2> "$O/$w.T$i.err"
    echo "$w T$i seed=$s rc=$? $(tail -n 1 "$O/$w.T$i.out" | cut -c1-400)"
  done
  python3 port_bench/control.py --workload "$w" --seconds 5 \
    --seeds $((base + 201)),$((base + 202)),$((base + 203)) \
    > "$O/$w.control.out" 2> "$O/$w.control.err"
  echo "$w control rc=$?"
  cut -c1-300 "$O/$w.control.out"
done
