"""Register layouts of the s8 warpgroup products (``csrc/wgmma.cuh``) that
the host side of a kernel has to know.

A thread of an m64nNk32 s8 ``wgmma`` holds the int32 sums of columns
8 j + 2 q and 8 j + 2 q + 1 (q = lane % 4), and bytes 4 q .. 4 q + 3 of each
16 input channels of its A operand.  A kernel that requantizes a product's
sums and feeds them, as they sit in the thread, to the next product as A
reads every 16 input channels of that product's weights in ``S8_SUM_ORDER``:
slot s is channel ``S8_SUM_ORDER[s]`` (slot 4 q + e is channel
8 (e // 2) + 2 q + e % 2).  The int8 tower's 1x1 convs (``ops/qtower.py``)
and the int8 chain's stages after the first (``ops/probes.py``) do.
"""

S8_SUM_ORDER = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)
