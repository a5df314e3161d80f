"""Host-side helpers: device resolution, packing, math dispatch, builds."""

from .packing import (array_to_symmetric_matrix, packed_index_arrays,
                      packed_prefactor, packed_size,
                      symmetric_matrix_to_array)

__all__ = ["symmetric_matrix_to_array", "array_to_symmetric_matrix",
           "packed_index_arrays", "packed_prefactor", "packed_size"]
