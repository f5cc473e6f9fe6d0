"""Container writers: DDS, KTX, PVR.

Byte-exact per the reference's writers (`lib/src/SaveDds.cpp`,
`SaveKtx.cpp`, `SavePvr.cpp`), including the differing surface orders: DDS is
element->face->mip->volume, KTX and PVR are mip->depth->face.

Copied from ``cuttlefish_tpu/containers/__init__.py`` with its imports pointed at
the port; its logic is unchanged.
"""
