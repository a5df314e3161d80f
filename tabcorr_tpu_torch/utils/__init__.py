"""Host-side helpers: device resolution, packing, math dispatch, builds."""
