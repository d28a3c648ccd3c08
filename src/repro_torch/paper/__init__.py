"""The paper's evaluation on the port: twins of the reference's table and
figure scripts (``benchmarks/table2_conventional.py``,
``table3_generalization.py``, ``table4_characteristics.py``,
``fig7_sampling.py``, ``scenario_sweep.py`` and their ``common.py``), one
module each under the reference's file name. Each runs as
``python -m repro_torch.paper.<name>`` with the reference's flags plus
``--device`` (the card by default, ``cpu`` only when asked)."""
