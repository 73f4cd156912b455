from multimodal_emotion_detection_tpu_torch.parallel.vmap_sweep import (  # noqa: F401
    train_ensemble,
    vmapped_lr_sweep,
)
