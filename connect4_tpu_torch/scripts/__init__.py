"""The run and measurement tools of the port, one module for each tool of the
JAX package's ``scripts/`` under the same file name. Each runs as

    python -m connect4_tpu_torch.scripts.<name> [--help]

does its work in a plain function that returns a dict (the tests and
``chip_smoke.py`` call it), prints its human-readable lines and then one
JSON line. The tools that compute take ``--device`` (default ``cuda``; they
raise without a card unless given ``--device cpu``); those that only read
and write files (``compare_runs``, ``game_stats``, ``plot_training_graphs``,
``view_games``, ``ship_run_artifacts``) take no device and need no card.
Tables are the port's JSON tables (``training.tables``), never pandas
pickles.

Measurement tools: ``selfplay_breakdown``, ``profile_search``,
``profile_refill_wave``, ``sweep_search_batch``, ``descent_depth_profile``,
``measure_compile``, ``pallas_eval_speed`` (the tower kernel against the
library's convolutions on gen-161).
Run tools: ``matches``, ``reevaluate_run``, ``plot_training_graphs``,
``compare_runs``, ``evaluate_posn``, ``view_games``, ``game_stats``,
``verify_supervised``, ``ship_run_artifacts``, ``k_head_to_head``,
``draw_bucket_diagnosis``, ``draw_bucket_experiment``, ``finalize_fullset``.
"""
