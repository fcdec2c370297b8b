"""The benchmark of ``spalinalg_tpu_torch`` on NVIDIA H100 cards (see
``README.md`` beside this file)."""
