"""The call paths the benchmark drives, one file each; see ``registry``."""
