from multimodal_emotion_detection_tpu_torch.data.dataset import (  # noqa: F401
    ArrayDataset,
    MultimodalArrays,
)
from multimodal_emotion_detection_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_arrays,
)
from multimodal_emotion_detection_tpu_torch.data.loader import (  # noqa: F401
    MultimodalLoader,
    create_dataloaders,
)
from multimodal_emotion_detection_tpu_torch.data.masking import (  # noqa: F401
    modality_dropout_mask,
    simulate_missing_modalities,
)
