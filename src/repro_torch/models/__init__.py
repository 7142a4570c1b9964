"""Model families of the port (mamba so far) and the family registry."""
