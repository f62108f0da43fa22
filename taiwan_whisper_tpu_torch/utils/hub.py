"""Model hub export (port of taiwan_whisper_tpu/utils/hub.py; reference:
training/push_to_hub.py one-shot upload).

Network access is environment-dependent; the function imports
huggingface_hub lazily and fails with a clear message when unavailable.
"""

from __future__ import annotations


def push_to_hub(model_dir: str, repo_id: str, private: bool = True,
                commit_message: str = "upload model") -> str:
    try:
        from huggingface_hub import HfApi
    except Exception as e:  # pragma: no cover
        raise RuntimeError(
            "push_to_hub requires the huggingface_hub package and network "
            "access; export locally via models.io.save_hf_checkpoint instead"
        ) from e
    api = HfApi()  # pragma: no cover
    api.create_repo(repo_id=repo_id, private=private, exist_ok=True)
    api.upload_folder(
        folder_path=model_dir, repo_id=repo_id, commit_message=commit_message
    )
    return f"https://huggingface.co/{repo_id}"
