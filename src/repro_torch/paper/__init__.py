"""The paper's evaluation drivers in PyTorch: Figs. 3-8, Table II and the
§IV-D analyses.

Counterpart of the reference's ``benchmarks/`` figure and table scripts
(``fig3_weights`` ... ``alg_analysis`` through ``common``). Each driver's
``run(quick=True, seed=0, ...)`` returns ``(rows, checks)`` with the
reference's row keys and check names, and writes its CSV under
``experiments/paper_torch/``; ``checks(rows)`` holds the paper's claims on
rows. ``python -m repro_torch.paper.run`` runs all seven.
"""
