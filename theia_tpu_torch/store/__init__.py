"""Store-side codecs the port needs: the TBLK wire format (a copy of
theia_tpu/store/wire.py)."""
