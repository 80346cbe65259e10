from .dcn import DCN
