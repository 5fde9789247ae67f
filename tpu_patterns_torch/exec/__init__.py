"""exec/ — process-group helpers for protocol children.

The port's copy of the part of ``tpu_patterns/exec/`` that the replica
fleet (``serve/replica.py``) needs: ``proc.py``'s ``popen_in_group``,
``python_argv`` and ``kill_process_group``.  The sweep engine, its cell
classifier and the warm workers wait for ROADMAP.md Queue 1 step 10.
"""
