"""Twins of the reference's five examples (``examples/*.py``), each run as
``python -m repro_torch.examples.<name>`` with the reference's flags and
defaults (plus ``--device`` where it touches the card: CUDA unless
``cpu``), printing the reference's lines and keeping its assertions:

* ``quickstart``: the classical solvers, a miniature CoRaiS trained with
  S-sample REINFORCE, and its greedy and sampled decisions;
* ``workload_replay``: a scenario driven live through the simulator,
  recorded to a trace, and replayed with the same completion metrics;
* ``train_lm``: reduced-config LM pretraining with an asynchronous
  checkpoint, a simulated crash and a resume;
* ``serve_multi_edge``: three LM edges with fitted phi, dispatched by the
  greedy scheduler and served to completion;
* ``elastic_restart``: :mod:`repro_torch.launch.elastic` in a subprocess.
"""
