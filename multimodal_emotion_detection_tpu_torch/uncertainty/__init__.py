from multimodal_emotion_detection_tpu_torch.uncertainty.calibration import (  # noqa: F401
    CalibrationMetrics,
    compute_calibration_metrics,
    per_bin_accuracy,
)
from multimodal_emotion_detection_tpu_torch.uncertainty.mc_dropout import (  # noqa: F401
    mc_dropout_predict,
)
from multimodal_emotion_detection_tpu_torch.uncertainty.temperature import (  # noqa: F401
    TemperatureScaling,
)
from multimodal_emotion_detection_tpu_torch.uncertainty.ensemble import (  # noqa: F401
    ensemble_predict,
)
from multimodal_emotion_detection_tpu_torch.models.fusion import (  # noqa: F401
    uncertainty_weighted_fusion,
)
