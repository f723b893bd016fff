"""Tools of the port: the soak, the capacity search and its ledger, the
buffer-64 attribution, the poster-table campaigns (tab4-tab8, the
low-latency sweep, 101 saturated reps) and the results tools (report,
compare_runs, doctor). Each runs as ``python -m
gpuaudiobench_tpu_torch.tools.<name>``, on the card unless it is given
``--device cpu``; the report, compare_runs and the ledger tools read
files only."""
