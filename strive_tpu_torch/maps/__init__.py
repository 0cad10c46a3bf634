from .store import MapStore, synthetic_map_store, upsample_store  # noqa: F401
from .queries import (  # noqa: F401
    get_map_crop,
    check_on_layer,
    check_line_layer,
    get_coll_point,
)
