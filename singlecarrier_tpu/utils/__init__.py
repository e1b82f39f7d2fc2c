from .cache import compilation_cache_dir, enable_compilation_cache

__all__ = ["compilation_cache_dir", "enable_compilation_cache"]
