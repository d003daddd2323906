"""Block families, one module each (``families/<name>.py``), found by
the name a configuration gives as ``block_family``: the weights a
family draws, its plain float32 reference and its operations a token.
A new family is a new file here; nothing else changes for it.
"""
