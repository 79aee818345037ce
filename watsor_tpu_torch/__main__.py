# Copy of watsor_tpu/__main__.py: imports adapted.
from watsor_tpu_torch.main import main

main()
