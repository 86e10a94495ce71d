"""Packaging for lddl_tpu (console scripts mirror reference setup.py:63-74)."""

from setuptools import find_packages, setup

setup(
    name='lddl_tpu',
    version='0.1.0',
    description=('TPU-native language dataset preprocessing and data '
                 'loading for large-scale pretraining'),
    packages=find_packages(include=['lddl_tpu', 'lddl_tpu.*',
                                    'lddl_tpu_torch', 'lddl_tpu_torch.*']),
    package_data={'lddl_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh',
                                    'csrc/*.cpp']},
    python_requires='>=3.10',
    install_requires=[
        'numpy',
        'pyarrow>=4.0.1',
        'jax',
        'flax',
        'optax',
        'orbax-checkpoint',
        'transformers',
    ],
    extras_require={
        'download': ['requests', 'tqdm', 'wikiextractor', 'gdown',
                     'news-please'],
        'test': ['pytest'],
    },
    entry_points={
        'console_scripts': [
            'download_wikipedia=lddl_tpu.cli:download_wikipedia',
            'download_books=lddl_tpu.cli:download_books',
            'download_common_crawl=lddl_tpu.cli:download_common_crawl',
            'download_open_webtext=lddl_tpu.cli:download_open_webtext',
            'preprocess_bert_pretrain=lddl_tpu.cli:preprocess_bert_pretrain',
            'preprocess_bart_pretrain=lddl_tpu.cli:preprocess_bart_pretrain',
            'preprocess_codebert_pretrain='
            'lddl_tpu.cli:preprocess_codebert_pretrain',
            'preprocess_packed_pretrain='
            'lddl_tpu.cli:preprocess_packed_pretrain',
            'prepare_codesearchnet=lddl_tpu.cli:prepare_codesearchnet',
            'pretrain_bert=lddl_tpu.cli:pretrain_bert',
            'balance_shards=lddl_tpu.cli:balance_shards',
            'generate_num_samples_cache='
            'lddl_tpu.cli:generate_num_samples_cache',
            'lddl-analyze=lddl_tpu.analysis.cli:main',
            'lddl-monitor=lddl_tpu.telemetry.monitor:main',
            'lddl-perf=lddl_tpu.telemetry.perf:main',
            'lddl-audit=lddl_tpu.telemetry.audit:main',
            'lddl-data-server=lddl_tpu.loader.service:main',
            'lddl-replay=lddl_tpu.replay.cli:main',
            'lddl-incident=lddl_tpu.training.flight:main',
        ],
    },
)
