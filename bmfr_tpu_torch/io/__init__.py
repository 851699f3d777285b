"""Host-side IO of the port: the synthetic orbit scene, the native C++ IO
library (EXR, PNG, the threaded loader), the camera header parser, TUNI
scene directories and their export."""
