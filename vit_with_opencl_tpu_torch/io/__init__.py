from .binfmt import (  # noqa: F401
    load_image_data,
    load_weights,
    parse_index_from_filename,
    round_6dp,
    save_image_data,
    save_weights,
    weight_names,
    weight_shapes,
    weights_to_dict,
)
from .labels import IMAGENET_LABELS  # noqa: F401
