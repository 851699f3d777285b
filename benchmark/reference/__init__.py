"""The benchmark's plain reference (:mod:`.bmfr`) and the frozen NumPy
oracle it is pinned to (:mod:`.oracle_reference`,
:mod:`.oracle_reference_vec`). Nothing here imports the program under
test."""
