"""The frame's compulsory bytes, whatever kernels do the work: the four
input planes read once, the carried state read once and written once at
the configuration's layout (the bf16 pack: 8 words a pixel; the
raw-plane state: five float32 planes and the u8 spp), and the result
written once where the state does not hold it."""

TRACE_NAME = None

STATE_BYTES_PER_PX = {"PackedState": 8 * 4, "TemporalState": 5 * 12 + 1}


def count(s, config):
    px = s.image_width * s.image_height
    carry = config["carry"]
    result = 0 if carry == "TemporalState" else 12
    return (4 * 12 + 2 * STATE_BYTES_PER_PX[carry] + result) * px, 0
