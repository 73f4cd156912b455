"""The port's kernels: each ``csrc/`` source behind a wrapper of its own.

Importing this package registers the serving kernels' custom ops in the
``med_torch`` namespace (``logmel``, ``lstm2_infer``, ``gru2_infer``,
``lstm1_infer``, ``gru1_infer``, ``flash_fwd``), which is all that
``torch.export.load`` needs to read a program ``tools.export`` wrote.
"""

from multimodal_emotion_detection_tpu_torch.ops import (  # noqa: F401
    flash_attention,
    logmel,
    lstm_kernel,
)
