from .views import (  # noqa: F401
    VIEW_AXIS,
    Sharder,
    ViewMesh,
    make_view_mesh,
    replicate,
    row_sharder,
    view_sharder,
)
