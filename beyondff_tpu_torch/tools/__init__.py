"""The port's stage and sweep CLIs: ``python -m beyondff_tpu_torch.tools.<name>``.

Thin copies of the JAX package's ``tools/*.py`` with ``--device`` (``cuda``
unless named) and, for evaluation, ``--table`` and ``--no-pr-curves``.
"""
